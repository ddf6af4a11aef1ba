"""Engine configuration: model architecture + engine runtime knobs, the
port's copy of ``dynamo_tpu/engine/config.py``.

``ModelConfig`` keeps every field of the JAX package's so the two packages
describe a model the same way; the forward (engine/model.py) refuses the
switches it does not implement yet. ``EngineArgs`` keeps the knobs the
port serves with, and names the JAX package's other knobs so that setting
one of them fails loudly instead of being ignored.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

#: static cap on prefill chunks co-scheduled into one ragged step; extra
#: chunks wait a step
RAGGED_MAX_CHUNKS = 4


@dataclass
class ModelConfig:
    """Decoder architecture: Llama-family GQA or DeepSeek MLA, dense or MoE
    (the same fields as the JAX package's)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    #: HF rope_scaling dict (linear / yarn / llama3 / longrope)
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # MoE (0 experts = dense MLP)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    moe_intermediate_size: Optional[int] = None
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    scoring_func: str = "softmax"
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    # attention extras
    qkv_bias: bool = False
    qk_norm: bool = False
    o_bias: bool = False
    sliding_window: Optional[int] = None
    layer_windows: Optional[tuple] = None
    attention_sinks: bool = False
    moe_activation: str = "swiglu"
    router_logit_bias: bool = False
    # Gemma family
    embed_scale: bool = False
    norm_plus_one: bool = False
    hidden_activation: str = "silu"
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sandwich_norms: bool = False
    query_pre_attn_scalar: Optional[float] = None
    # MLA (DeepSeek V2/V3)
    kv_lora_rank: int = 0
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.layer_windows is not None:
            self.layer_windows = tuple(int(w or 0) for w in self.layer_windows)
            if len(self.layer_windows) != self.num_layers:
                raise ValueError(
                    f"layer_windows has {len(self.layer_windows)} entries "
                    f"for {self.num_layers} layers")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def rope_cache_dim(self) -> int:
        """MLA rope-part cache width: qk_rope_head_dim rounded up to a
        multiple of 128, the JAX package's cache layout."""
        return -(-self.qk_rope_head_dim // 128) * 128

    @property
    def moe_ffn_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def num_dense_prefix_layers(self) -> int:
        """Layers in the separate ``dense_layers`` param stack (the MoE
        models' dense prefix); they are cache layers 0 .. k-1."""
        return self.first_k_dense_replace if self.is_moe else 0

    @property
    def kv_cache_spec(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """((heads, dim) of k_cache, (heads, dim) of v_cache) per slot:
        [KV, head_dim] both for GQA; for MLA the normalised latent c
        [1, kv_lora_rank] in k_cache and the post-RoPE k_rot zero-padded to
        [1, rope_cache_dim] in v_cache."""
        if self.is_mla:
            return ((1, self.kv_lora_rank), (1, self.rope_cache_dim))
        return ((self.num_kv_heads, self.head_dim),
                (self.num_kv_heads, self.head_dim))

    @staticmethod
    def from_hf_config(d: dict) -> "ModelConfig":
        """Map a HuggingFace ``config.json`` dict onto ModelConfig, field
        for field as the JAX package does (its ``from_hf_config``). The
        families the port's forward lacks come out with their switches set,
        and ``check_supported`` refuses them."""
        arch = (d.get("architectures") or [""])[0].lower()
        is_deepseek = "deepseek" in arch
        is_gpt_oss = "gptoss" in arch
        is_gemma2 = "gemma2" in arch
        is_gemma = "gemma" in arch  # gemma-1 OR gemma-2
        if "gemma3" in arch:
            raise NotImplementedError(
                "Gemma-3 (dual-base rope, plus-one qk-norm) is not "
                "supported yet; Gemma 1/2 are")
        is_phi3 = "phi3" in arch  # Phi-3 family AND Phi-4 (same arch class)
        if is_phi3:
            if float(d.get("partial_rotary_factor") or 1.0) != 1.0:
                raise NotImplementedError(
                    "partial rotary (phi-4-mini style) is not supported")
            sc = d.get("rope_scaling")
            if sc and sc.get("rope_type", sc.get("type")) == "longrope":
                # longrope factors live in the scaling dict but the window
                # sizes live on the top-level config — carry them together
                # (rope_params reads only the dict)
                sc = dict(sc)
                sc["max_position_embeddings"] = d.get(
                    "max_position_embeddings", 4096)
                sc["original_max_position_embeddings"] = d.get(
                    "original_max_position_embeddings",
                    sc.get("original_max_position_embeddings",
                           sc["max_position_embeddings"]))
                d = {**d, "rope_scaling": sc}
        if "qwen3moe" in arch:
            # the uniform layer stack requires every non-prefix
            # layer to be MoE; refuse irregular sparsity loudly rather than
            # serving a silently-wrong forward
            if d.get("mlp_only_layers") or d.get("decoder_sparse_step", 1) != 1:
                raise ValueError(
                    "Qwen3-MoE checkpoints with mlp_only_layers or "
                    "decoder_sparse_step != 1 interleave dense layers mid-"
                    "stack, which the stacked-layer forward does not support")
        mla = is_deepseek and d.get("kv_lora_rank") is not None
        layer_windows = None
        if is_gemma2:
            # HF Gemma2: sliding attention on EVEN layer indices
            # (Gemma2DecoderLayer: is_sliding = not bool(layer_idx % 2))
            L = d.get("num_hidden_layers", 26)
            w = d.get("sliding_window", 4096)
            layer_windows = tuple(w if i % 2 == 0 else 0 for i in range(L))
        if is_gpt_oss:
            L = d.get("num_hidden_layers", 36)
            types = d.get("layer_types") or [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(L)]
            layer_windows = tuple(
                d.get("sliding_window", 128) if t == "sliding_attention" else 0
                for t in types)
        return ModelConfig(
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 11008),
            num_layers=d.get("num_hidden_layers", 32),
            num_heads=d.get("num_attention_heads", 32),
            num_kv_heads=d.get("num_key_value_heads", d.get("num_attention_heads", 32)),
            head_dim=d.get("head_dim") if not is_deepseek else None,
            embed_scale=is_gemma,
            norm_plus_one=is_gemma,
            hidden_activation=("gelu_tanh" if is_gemma else "silu"),
            attn_logit_softcap=(d.get("attn_logit_softcapping") or 0.0)
            if is_gemma2 else 0.0,
            final_logit_softcap=(d.get("final_logit_softcapping") or 0.0)
            if is_gemma2 else 0.0,
            sandwich_norms=is_gemma2,
            query_pre_attn_scalar=(d.get("query_pre_attn_scalar")
                                   if is_gemma2 else None),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            num_experts=(d.get("num_local_experts")       # mixtral
                         or d.get("n_routed_experts")      # deepseek
                         or d.get("num_experts", 0)        # qwen3-moe
                         or 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            n_shared_experts=d.get("n_shared_experts", 0) or 0,
            first_k_dense_replace=d.get("first_k_dense_replace", 0) or 0,
            scoring_func=d.get("scoring_func",
                               "sigmoid" if "deepseekv3" in arch else "softmax"),
            # Mixtral and gpt-oss renormalize their top-k gates (their HF
            # configs have no such key); DeepSeek carries the flag explicitly
            norm_topk_prob=d.get("norm_topk_prob",
                                 "mixtral" in arch or is_gpt_oss),
            routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
            n_group=d.get("n_group", 1) or 1,
            topk_group=d.get("topk_group", 1) or 1,
            kv_lora_rank=d.get("kv_lora_rank", 0) if mla else 0,
            q_lora_rank=d.get("q_lora_rank") if mla else None,
            qk_nope_head_dim=d.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=d.get("qk_rope_head_dim", 64),
            v_head_dim=d.get("v_head_dim", 128),
            qkv_bias=("qwen2" in arch
                      or (is_gpt_oss and d.get("attention_bias", True))),
            qk_norm="qwen3" in arch,
            o_bias=is_gpt_oss and d.get("attention_bias", True),
            layer_windows=layer_windows,
            attention_sinks=is_gpt_oss,
            moe_activation="swiglu_oss" if is_gpt_oss else "swiglu",
            router_logit_bias=is_gpt_oss,
            # qwen2 writes sliding_window but gates it behind
            # use_sliding_window, whose HF default is False; mistral-style
            # configs apply the window unconditionally; gpt-oss windows are
            # per-layer (layer_windows above)
            sliding_window=(d.get("sliding_window")
                            if not is_gpt_oss
                            and d.get("use_sliding_window",
                                      "qwen2" not in arch) else None),
        )

    @staticmethod
    def from_pretrained(path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f))

    @staticmethod
    def tiny(vocab_size: int = 256) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, dtype="float32",
        )

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
            max_position_embeddings=8192,
        )

    @staticmethod
    def llama3_70b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, rope_theta=500000.0,
            max_position_embeddings=8192,
        )

    @staticmethod
    def llama3_1b() -> "ModelConfig":
        """Llama-3.2-1B shape."""
        return ModelConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
            rope_theta=500000.0, max_position_embeddings=8192,
            tie_word_embeddings=True,
        )


#: the JAX package's engine knobs this port does not implement yet: name →
#: (the value that means "off", the ROADMAP item that ports it). Setting
#: one to anything else raises at construction.
UNPORTED_KNOBS = {
    "tp_size": (1, "A11"),
    "dp_size": (1, "A11"),
    "pp_size": (1, "A11"),
    "use_pallas_attention": (False, "B1: the port's kernel is always on"),
}


@dataclass
class EngineArgs:
    """Engine runtime knobs (the JAX package's names and defaults)."""

    block_size: int = 16
    num_blocks: Optional[int] = None  # None = size from free device memory
    max_num_seqs: int = 64
    max_num_batched_tokens: int = 2048
    max_model_len: int = 4096
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    watermark: float = 0.01
    #: share of the device memory left free after the weights that the KV
    #: pool takes, when num_blocks is None
    kv_cache_memory_fraction: float = 0.6
    #: () = powers of two up to max_num_seqs (caps the rows of one step)
    decode_batch_buckets: tuple = ()
    #: packed-token buckets for the ragged step; () = powers of two from 8
    #: up to max_num_batched_tokens
    ragged_token_buckets: tuple = ()
    #: publish one KV stored event per prefill chunk instead of one per
    #: request; None = read DYN_KV_EVENT_PER_CHUNK
    kv_event_per_chunk: Optional[bool] = None
    #: multi-tenant QoS scheduling; False = flat FIFO
    qos_scheduling: bool = True
    #: QoS policy override (dynamo_tpu_torch.qos.QosConfig); None = env
    qos: Optional[object] = None
    seed: int = 0
    #: K > 1: decode-only batches that need no host round trip run K
    #: steps and their draws in one burst (one captured graph on the card)
    multi_step_decode: int = 1
    #: run every token bucket's step signatures before serving
    #: (``AsyncTorchEngine.warmup``); the worker does it before it registers
    warmup_buckets: bool = False
    #: None / "auto" = the model dtype; "int8" = int8 pages with f32 scales
    #: per (slot, kv-head), about half the bytes (engine/cache.py)
    kv_cache_dtype: Optional[str] = None
    #: depth-2 pipelining of single-step decode: step N+1 is launched with
    #: step N's sampled tokens fed device to device, so the host's copy,
    #: commit and emission of step N overlap step N+1
    pipeline_decode: bool = True
    #: structured decoding: compile guided-decoding constraints into dense
    #: device tables and run the FSM inside the sampling step, so
    #: constrained rows ride the ragged step and the pipelined loop with no
    #: host sync. False keeps every constraint on the host oracle. Also
    #: gated by DYN_STRUCTURED=0 at run time.
    structured_device: bool = True
    #: byte budget (MiB) of the device FSM arena (the next-state table
    #: costs 4·vocab bytes a state); None = DYN_STRUCTURED_TABLE_MB, or 64.
    #: Constraints whose state closure does not fit use the host oracle.
    structured_table_mb: Optional[float] = None
    #: layer-interleaved disagg transfer: a prefill worker ships the last
    #: chunk's blocks as this many layer groups when the decode worker
    #: advertised ``kv_layers`` (clamped to the layer count); a decode
    #: worker advertises it when this is > 1. <= 1: whole-bundle tails
    kv_transfer_layer_groups: int = 4
    #: direct device-to-device KV transfer for disagg (same process, or
    #: CUDA IPC on one card: ``disagg/transfer.py``); False = host-staged
    #: bundles only
    kv_transfer_direct: bool = True
    #: speculative decoding: draft up to this many tokens and verify them
    #: in ONE ragged forward, greedy-invariant (the tokens plain greedy
    #: decode gives). 0 = off. Greedy batches without logprobs, logit
    #: edits or host-oracle rows only
    speculative_tokens: int = 0
    #: how drafts are made: "prompt_lookup" (the trailing n-gram matched
    #: in the sequence's own history) or "draft_layers" (layer-skip
    #: self-drafting: the first speculative_draft_layers layers and the
    #: shared LM head, ``model.make_draft_fn``)
    speculative_method: str = "prompt_lookup"
    #: layer count of the layer-skip draft (speculative_method=
    #: "draft_layers"), in (0, num_layers]
    speculative_draft_layers: int = 0
    #: speculative-decode auto-disable: when the rolling measured gain over
    #: spec_gain_window verify dispatches stays < 1, fall back to plain
    #: decode and re-probe after spec_reprobe_steps engine steps. 0
    #: disables the governor
    spec_gain_window: int = 64
    spec_reprobe_steps: int = 4096
    #: on-device weight quantization: "int8", "int8-gN" or "int4-gN"
    #: (engine/quant.py); the matmul weights stay quantized on the card and
    #: every product through them runs the dequant-GEMM (ops/qmm.py)
    quantization: Optional[str] = None
    #: KVBM tiers (0 = off): G2 host bytes, and G3 as a directory and
    #: its bytes (``kvbm/``)
    kvbm_host_bytes: int = 0
    kvbm_disk_dir: Optional[str] = None
    kvbm_disk_bytes: int = 0
    #: preempt-to-swap: under KV pressure a victim's device pages move to
    #: host memory (the same value / packed int8 bundles the G2 tier
    #: holds) and come back before its next step, instead of being
    #: released and prefilled again. Recompute preemption stays the
    #: fallback when the host budget is exhausted or a copy fails.
    preempt_swap: bool = True
    #: host bytes for swapped-out KV. None = share the G2 tier's budget
    #: when kvbm_host_bytes > 0, else 1 GiB of its own
    swap_host_bytes: Optional[int] = None
    # knobs of the JAX package not ported yet (UNPORTED_KNOBS)
    tp_size: int = 1
    dp_size: int = 1
    pp_size: int = 1
    use_pallas_attention: bool = False

    def __post_init__(self):
        if self.speculative_method not in ("prompt_lookup", "draft_layers"):
            raise ValueError(
                f"speculative_method={self.speculative_method!r} unknown "
                "(prompt_lookup or draft_layers)")
        if (self.speculative_method == "draft_layers"
                and self.speculative_tokens > 0
                and self.speculative_draft_layers < 1):
            raise ValueError("speculative_method='draft_layers' needs "
                             "speculative_draft_layers >= 1")
        for name, (off, item) in UNPORTED_KNOBS.items():
            if getattr(self, name) != off:
                raise ValueError(
                    f"EngineArgs.{name}={getattr(self, name)!r} is not "
                    f"supported by the torch port yet (ROADMAP {item}); "
                    f"leave it at {off!r}")
        if self.kv_cache_dtype not in (None, "auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} not supported "
                "(None/'auto' = model dtype, or 'int8')")
        if self.quantization is not None:
            # a field-named config error, not a traceback at weight load
            from dynamo_tpu_torch.engine.quant import parse_spec
            try:
                parse_spec(self.quantization)
            except ValueError as e:
                raise ValueError(
                    f"quantization={self.quantization!r} invalid: {e}"
                ) from None
        if self.kv_event_per_chunk is None:
            self.kv_event_per_chunk = os.environ.get(
                "DYN_KV_EVENT_PER_CHUNK", "").lower() not in ("", "0", "false")
        if not self.decode_batch_buckets:
            b = [2**i for i in range(0, max(1, self.max_num_seqs).bit_length())
                 if 2**i <= self.max_num_seqs] or [1]
            if b[-1] < self.max_num_seqs:
                b.append(self.max_num_seqs)
            self.decode_batch_buckets = tuple(b)
        if not self.ragged_token_buckets:
            cap = max(8, self.max_num_batched_tokens)
            b = [2**i for i in range(3, cap.bit_length()) if 2**i <= cap]
            if b[-1] < cap:
                b.append(cap)
            self.ragged_token_buckets = tuple(b)

    @property
    def max_blocks_per_seq(self) -> int:
        return math.ceil(self.max_model_len / self.block_size)

    def bucket_ragged_tokens(self, n: int) -> int:
        """Packed-token bucket for a ragged step of ``n`` real tokens."""
        for b in self.ragged_token_buckets:
            if n <= b:
                return b
        return self.ragged_token_buckets[-1]

    def ragged_rows(self, t_bucket: int) -> int:
        """Row count of the ragged step's metadata arrays, derived from the
        token bucket (each row holds at least one token)."""
        return max(1, min(self.max_num_seqs, t_bucket))
