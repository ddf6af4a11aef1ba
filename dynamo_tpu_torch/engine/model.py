"""Decoder forward pass over a paged KV cache, in PyTorch: GQA (Llama,
Mistral, Qwen2/3, Gemma-1/2 and gpt-oss's attention switches) and DeepSeek
MLA, each with a dense or a MoE MLP.

The port of ``dynamo_tpu/engine/model.py``'s single-device paths:

- ``make_ragged_step_fn`` (``forward(ragged=...)``): one call is one engine
  step; every prefill chunk and decode row of a scheduler plan rides one
  packed token batch. GQA attention runs through the ragged paged kernel
  (ops/ragged_attention.py). MLA attention decomposes as the JAX package's
  ``_mla_ragged_olat`` does: decode rows through the MLA latent-decode
  kernel (ops/mla_decode.py, one launch per layer for all rows), chunk
  tokens over the chunk grid through the MLA flash-prefill kernel's paged
  entry (ops/flash_prefill.py, one launch per layer) on the card, and
  through a segment walk (``mla_attention_seg``, the reference's own XLA
  path ``_mla_attention_seg`` in PyTorch) on the CPU.
- ``make_multi_decode_fn`` (``multi_decode``, its ragged layout): K
  chained decode steps and their draws in one call, the burst of
  ``EngineArgs.multi_step_decode``.
- ``make_ragged_verify_fn``: speculative decoding's verify, the ragged
  step's forward (factored out of ``make_ragged_step_fn``, shared) with the
  greedy token and its logprob at every packed position, optionally under
  per-position FSM mask words; ``make_draft_fn``: the layer-skip draft, a
  greedy burst through the first D layers.
- ``make_forward_fn`` (``forward(ragged=None)``) for [B, S] batches: S > 1
  through the flash prefill kernel (ops/flash_prefill.py; GQA, or the MLA
  flash-prefill kernel over the layer's pages), S == 1 through the paged
  decode kernel (ops/paged_attention.py, GQA) or the MLA latent-decode
  kernel; ``make_embed_fn`` on top of it: mean-pooled sequence embeddings
  of either family.

MoE layers route tokens with ``router_weights`` (softmax or sigmoid
scoring, group-limited choice, ``norm_topk_prob``, routed scaling) and
compute every expert for every token (``mlp_moe``: plain matrix products
over [E, N, F], as the JAX package's single-device path leaves them to
XLA), plus the shared experts; a MoE model's dense prefix is its own
``dense_layers`` stack and the first cache layers.

Differences from the JAX package, each deliberate:

- Layers run in a Python loop over the stacked ``[L, ...]`` weights in
  place of ``lax.scan``; PyTorch runs eagerly, and on the card the engine
  captures each step signature as a CUDA graph in place of a program
  compiled per token bucket (``engine/graphs.py``).
- The KV write is an in-place ``index_copy_`` into the caller's cache at
  ``slot_map`` (padding tokens write into the null block, as in JAX); an
  int8 cache stores ``quantize_kv`` of k and v (MLA: of the latent and of
  the rope part). It replaces buffer donation: the returned caches are the
  tensors passed in.
- The GQA step does not read the chunk-grid operands; the MLA step reads
  them and never reads ``rows3`` on the host. The MLA prefill kernel stops
  each query tile at its last visible key on the device. The CPU's
  segment walk covers the whole table width (the JAX loop stops at the
  batch's longest row, a bound PyTorch would have to read on the host);
  the extra segments are fully masked and change nothing.
- The MLA S > 1 forward reads the layer's pages through the block tables
  in the kernel; the JAX package gathers them first. Same numbers.
- Every architecture switch the port lacks raises ``NotImplementedError``
  when a step is built: gpt-oss's expert activation, and sinks or sliding
  windows on MLA (which the JAX MLA path ignores).
- Gemma-2's attention logit softcap runs inside the attention kernels' online
  softmax (the JAX package computes it in XLA, off its kernels). Sinks enter
  the kernels in f32: an engine converts each layer's sink row once
  (:func:`f32_sinks`), not per step.

The architecture switches follow the JAX forward: q/k/v bias, Qwen3's
per-head q/k RMSNorm before RoPE, Gemma-2's ``query_pre_attn_scalar`` (q
pre-scaled by sqrt(hd / qpas) in q's dtype), per-layer or global sliding
windows and sinks passed to every attention call, the o bias, Gemma-2's
post-attention and post-MLP norms on the sublayer outputs, GeLU-tanh in the
dense MLP, the sqrt(D) embedding scale (:func:`embed_tokens`; a tied head
reads the unscaled table) and the final logit softcap (:func:`lm_logits`).

Weights keep the JAX layout ``[in, out]``, so each projection is
``x @ W`` exactly as in the reference. A quantized weight
(``engine/quant.py``: ``{"q", "s"[, "z"]}``, stacked like the weight it
replaces, from ``init_params(quantization=...)``, the loader or the engine)
goes through ``matmul``: the dequant-GEMM's wrapper (``ops/qmm.py``) by
default, or its plain version. Every site the JAX package quantizes does
so: the q/k/v/o projections, MLA's q_a, q_b, wq, kv_a and wo (w_uk and
w_uv stay at model dtype), the dense and shared-expert MLPs, the MoE expert
stacks (the kernel's batched form) and an untied LM head; a tied head and
the embedding gather stay at model dtype. Each layer's weight is read
through :func:`layer_weight`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.cache import NULL_BLOCK, layer_pages, write_kv
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.quant import (
    empty_qtensor, is_qtensor, leaf_group, parse_spec, quantize,
    quantize_into, slice_layers,
)
from dynamo_tpu_torch.ops.flash_prefill import (
    flash_mla_prefill_paged, flash_prefill_paged,
)
from dynamo_tpu_torch.ops.mla_decode import (
    gather_latent, geometry_error, mla_paged_decode,
)
from dynamo_tpu_torch.ops.paged_attention import (
    decode_rows, paged_attention_decode,
)
from dynamo_tpu_torch.ops.qmm import geometry_error as qmm_geometry_error
from dynamo_tpu_torch.ops.qmm import quant_matmul
from dynamo_tpu_torch.ops.ragged_attention import (
    HEAD_DIMS, MAX_GROUP, ragged_paged_attention,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_NEG = -1e30
#: chunk-grid tile width (tokens per grid row), as in the JAX package
RAGGED_TILE = 32


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the port serves {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every architecture switch the port's forward lacks: the
    gpt-oss expert activation (ROADMAP A9), and sinks or sliding windows
    on MLA, which the JAX package's MLA attention ignores."""
    if cfg.is_moe and cfg.moe_activation != "swiglu":
        raise NotImplementedError(
            f"moe_activation {cfg.moe_activation!r}: the torch port's MoE "
            "runs swiglu experts; gpt-oss's clamped swiglu with expert "
            "biases is not ported yet (ROADMAP A9)")
    if cfg.hidden_activation not in ("silu", "gelu_tanh"):
        raise NotImplementedError(
            f"hidden_activation {cfg.hidden_activation!r}: the port's MLP "
            "takes silu or gelu_tanh")
    mla_bad = [name for name, on in (
        ("attention_sinks", cfg.attention_sinks),
        ("sliding_window", bool(cfg.sliding_window)),
        ("layer_windows", cfg.layer_windows is not None)) if on]
    if cfg.is_mla and mla_bad:
        raise NotImplementedError(
            "MLA with " + ", ".join(mla_bad) + ": the MLA attention has no "
            "sinks or windows (nor has the JAX package's)")


def check_kernel_geometry(cfg: ModelConfig) -> None:
    """Raise unless the port's CUDA attention kernels take this model's
    heads. GQA: head_dim in HEAD_DIMS (64, 128, 256), a group of at most
    MAX_GROUP, any attention softcap >= 0 (the kernels' online softmax
    caps in place).
    MLA: H a multiple of 16, latent rank and rope cache width multiples
    of 64, for the latent-decode and the flash-prefill kernel alike
    (ops/mla_decode.py), with bf16, f32 or int8 pages. An engine on the
    card checks this when it is built, so no step routes around a kernel at
    run time."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.is_mla:
        why = geometry_error(H, cfg.kv_lora_rank, cfg.rope_cache_dim)
        if why:
            raise ValueError(f"the CUDA MLA decode and prefill kernels "
                             f"cannot take this model: {why}")
        return
    if (hd not in HEAD_DIMS or H % KV or H // KV > MAX_GROUP
            or cfg.attn_logit_softcap < 0):
        raise ValueError(
            f"the CUDA attention kernels take head_dim in {HEAD_DIMS}, "
            f"H / KV <= {MAX_GROUP} and a softcap >= 0; this model has "
            f"head_dim {hd}, H {H}, KV {KV}, softcap "
            f"{cfg.attn_logit_softcap}")


def check_quant_geometry(params: dict, dtype: torch.dtype) -> None:
    """Raise unless the dequant-GEMM takes every quantized weight of
    ``params`` in a ``dtype`` model: bf16 activations, I % 16, O % 8 and
    groups dividing I (``ops/qmm.py``). An engine on the card checks this
    when it is built."""
    def walk(tree, path):
        for k, v in tree.items():
            if is_qtensor(v):
                q, G = v["q"], v["s"].shape[-2]
                I = q.shape[-2] * (2 if q.dtype == torch.uint8 else 1)
                why = (f"bf16 activations (the model is {dtype})"
                       if dtype != torch.bfloat16 else
                       qmm_geometry_error(I, q.shape[-1], G))
                if why:
                    raise ValueError(f"the dequant-GEMM cannot take "
                                     f"{path}{k}: it needs {why}")
            elif isinstance(v, dict):
                walk(v, f"{path}{k}.")
    walk(params, "")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
#
# params = {
#   "embed": [V, D],
#   "layers": {                       (stacked on a leading L axis)
#     "attn_norm": [L, D], "mlp_norm": [L, D],
#     GQA: "wq": [L, D, H*hd], "wk": [L, D, KV*hd], "wv": [L, D, KV*hd],
#          "wo": [L, H*hd, D]; with the switches "bq": [L, H*hd],
#          "bk"/"bv": [L, KV*hd] (qkv_bias), "q_norm"/"k_norm": [L, hd]
#          (qk_norm), "bo": [L, D] (o_bias), "sink": [L, H] (sinks)
#     sandwich_norms: "post_attn_norm": [L, D], "post_mlp_norm": [L, D]
#     MLA: "wq": [L, D, H*(dn+dr)] or "q_a": [L, D, qr], "q_a_norm": [L, qr],
#          "q_b": [L, qr, H*(dn+dr)]; "kv_a": [L, D, r+dr],
#          "kv_a_norm": [L, r], "w_uk": [L, r, H*dn], "w_uv": [L, r, H*dv],
#          "wo": [L, H*dv, D]
#     dense MLP: "w_gate": [L, D, F], "w_up": [L, D, F], "w_down": [L, F, D]
#     MoE: "router": [L, D, E], "router_bias": [L, E] f32,
#          "w_gate": [L, E, D, Fm], "w_up": [L, E, D, Fm],
#          "w_down": [L, E, Fm, D]; shared experts "ws_gate": [L, D, Fs],
#          "ws_up": [L, D, Fs], "ws_down": [L, Fs, D]
#   },
#   "dense_layers": {...}  a MoE model's dense prefix (dense MLP), when any
#   "final_norm": [D], "lm_head": [D, V] (absent when tied)
# }


def _init_stack(cfg: ModelConfig, w, n: int, moe: bool, dtype, device,
                generator: torch.Generator, quant=None) -> dict:
    """One stacked layer group of ``n`` layers (dense or MoE MLP); ``w``
    draws one [in, out] matrix. Each layer, and each expert, is drawn on
    its own; the sinks from ``generator``. ``quant`` (bits, group)
    quantizes each matrix the JAX walk would as it is drawn."""
    D, H, KV, hd = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)

    def stacked(key, shape, fan_in, experts: int = 0):
        lead = (n, experts) if experts else (n,)
        ok, g = leaf_group(key, shape[0], *quant) if quant else (False, None)
        out = (empty_qtensor(lead, shape, quant[0], g, device) if ok else
               torch.empty((*lead, *shape), dtype=dtype, device=device))
        for i in range(n):
            for e in range(max(1, experts)):
                at = (i, e) if experts else i
                if ok:
                    quantize_into(out, at, w(shape, fan_in))
                else:
                    out[at].copy_(w(shape, fan_in))
        return out

    def ones(dim):
        return torch.ones((n, dim), dtype=dtype, device=device)

    def zeros(dim):
        return torch.zeros((n, dim), dtype=dtype, device=device)

    layers = {"attn_norm": ones(D), "mlp_norm": ones(D)}
    if cfg.sandwich_norms:  # Gemma-2 post-norms on the sublayer outputs
        layers["post_attn_norm"] = ones(D)
        layers["post_mlp_norm"] = ones(D)
    if cfg.is_mla:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            layers["q_a"] = stacked("q_a", (D, qr), D)
            layers["q_a_norm"] = ones(qr)
            layers["q_b"] = stacked("q_b", (qr, H * (dn + dr)), qr)
        else:
            layers["wq"] = stacked("wq", (D, H * (dn + dr)), D)
        layers["kv_a"] = stacked("kv_a", (D, r + dr), D)
        layers["kv_a_norm"] = ones(r)
        layers["w_uk"] = stacked("w_uk", (r, H * dn), r)
        layers["w_uv"] = stacked("w_uv", (r, H * dv), r)
        layers["wo"] = stacked("wo", (H * dv, D), H * dv)
    else:
        layers["wq"] = stacked("wq", (D, H * hd), D)
        layers["wk"] = stacked("wk", (D, KV * hd), D)
        layers["wv"] = stacked("wv", (D, KV * hd), D)
        layers["wo"] = stacked("wo", (H * hd, D), H * hd)
        if cfg.qkv_bias:
            layers["bq"] = zeros(H * hd)
            layers["bk"] = zeros(KV * hd)
            layers["bv"] = zeros(KV * hd)
        if cfg.qk_norm:
            layers["q_norm"] = ones(hd)
            layers["k_norm"] = ones(hd)
        if cfg.o_bias:
            layers["bo"] = zeros(D)
        if cfg.attention_sinks:
            layers["sink"] = (0.5 * torch.randn(
                (n, H), generator=generator, device=device,
                dtype=torch.float32)).to(dtype)
    if moe:
        Fm, E = cfg.moe_ffn_size, cfg.num_experts
        layers["router"] = stacked("router", (D, E), D)
        layers["router_bias"] = torch.zeros((n, E), dtype=torch.float32,
                                            device=device)
        layers["w_gate"] = stacked("w_gate", (D, Fm), D, E)
        layers["w_up"] = stacked("w_up", (D, Fm), D, E)
        layers["w_down"] = stacked("w_down", (Fm, D), Fm, E)
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fm
            layers["ws_gate"] = stacked("ws_gate", (D, Fs), D)
            layers["ws_up"] = stacked("ws_up", (D, Fs), D)
            layers["ws_down"] = stacked("ws_down", (Fs, D), Fs)
    else:
        Fi = cfg.intermediate_size
        layers["w_gate"] = stacked("w_gate", (D, Fi), D)
        layers["w_up"] = stacked("w_up", (D, Fi), D)
        layers["w_down"] = stacked("w_down", (Fi, D), Fi)
    return layers


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, quantization: Optional[str] = None) -> dict:
    """Random weights with the JAX package's shapes and scales: normal /
    sqrt(fan_in), norms one, biases and the router bias zero, sinks normal
    times 0.5. Drawn from ``generator``
    (which must live on ``device``) one matrix at a time — one layer, or
    one expert of a layer — so the f32 draw never adds more than one
    matrix to the footprint of a full-width model. ``quantization``
    (``engine/quant.py``'s specs) quantizes each matrix of a quantized
    leaf as it is drawn, into stacked ``{"q", "s"}``: no full-width stack
    of it ever exists, and the result equals ``quantize_params`` of the
    unquantized draw from the same generator."""
    check_supported(cfg)
    dtype = torch_dtype(cfg)
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    k_dense = cfg.num_dense_prefix_layers
    quant = parse_spec(quantization) if quantization else None

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
                / float(np.sqrt(fan_in))).to(dtype)

    params = {"embed": w((V, D), D),
              "layers": _init_stack(cfg, w, L - k_dense, cfg.is_moe, dtype,
                                    device, generator, quant),
              "final_norm": torch.ones((D,), dtype=dtype, device=device)}
    if k_dense:
        params["dense_layers"] = _init_stack(cfg, w, k_dense, False, dtype,
                                             device, generator, quant)
    if not cfg.tie_word_embeddings:
        ok, g = (leaf_group("lm_head", D, *quant) if quant
                 else (False, None))
        head = w((D, V), D)
        params["lm_head"] = quantize(head, quant[0], g) if ok else head
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float):
    xf = x.float()
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if w.dtype == torch.float32 and x.dtype != torch.float32:
        # f32 weights = loader-folded (1+w) norms (Gemma): scale in f32 and
        # cast once at the end
        return (xn * w).to(x.dtype)
    # HF Llama-style: x̂ cast back, then a same-dtype weight multiply
    return xn.to(x.dtype) * w


def rope_params(theta: float, hd: int, scaling: Optional[dict]):
    """(inv_freq [hd/2] numpy f32, attention_scaling) honoring HF
    rope_scaling: default, "linear", "yarn", "llama3" and "longrope".
    Anything else fails loudly."""
    half = hd // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    if not scaling or scaling.get("rope_type", scaling.get("type")) in (
            None, "default"):
        return inv.astype(np.float32), 1.0
    kind = scaling.get("rope_type", scaling.get("type"))
    factor = float(scaling.get("factor", 1.0))
    if kind == "linear":
        return (inv / factor).astype(np.float32), 1.0
    if kind == "yarn":
        orig = float(scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))

        def correction_dim(rot):
            return half * np.log(orig / (rot * 2 * np.pi)) / np.log(theta)

        low = correction_dim(beta_fast)
        high = correction_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = np.floor(low), np.ceil(high)
        low, high = max(low, 0), min(high, hd - 1)
        ramp = np.clip((np.arange(half) - low) / max(1e-3, high - low), 0, 1)
        mask = 1.0 - ramp  # 1 = extrapolate (high freq), 0 = interpolate
        inv = inv / factor * (1 - mask) + inv * mask
        attn = float(scaling.get("attention_factor")
                     or (0.1 * np.log(factor) + 1.0))
        if scaling.get("mscale") and scaling.get("mscale_all_dim"):
            def yarn_mscale(s, m):
                return 0.1 * m * np.log(s) + 1.0 if s > 1 else 1.0
            attn = (yarn_mscale(factor, float(scaling["mscale"]))
                    / yarn_mscale(factor, float(scaling["mscale_all_dim"])))
        return inv.astype(np.float32), attn
    if kind == "llama3":
        orig = float(scaling.get("original_max_position_embeddings", 8192))
        lo_f = float(scaling.get("low_freq_factor", 1.0))
        hi_f = float(scaling.get("high_freq_factor", 4.0))
        low_wl, high_wl = orig / lo_f, orig / hi_f
        wavelen = 2 * np.pi / inv
        out = np.where(wavelen > low_wl, inv / factor, inv)
        smooth = (orig / wavelen - lo_f) / (hi_f - lo_f)
        smoothed = (1 - smooth) * inv / factor + smooth * inv
        is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        out = np.where(is_mid, smoothed, out)
        return out.astype(np.float32), 1.0
    if kind == "longrope":
        if "max_position_embeddings" not in scaling:
            raise NotImplementedError(
                "longrope scaling requires max/original window sizes in the "
                "rope_scaling dict")
        max_pos = float(scaling["max_position_embeddings"])
        orig = float(scaling.get("original_max_position_embeddings", max_pos))
        factor = max_pos / orig
        ext = np.asarray(scaling["long_factor"] if factor > 1.0
                         else scaling["short_factor"], np.float64)
        if ext.shape[0] != half:
            raise ValueError(
                f"longrope factor array has {ext.shape[0]} entries, "
                f"head_dim/2 is {half}")
        attn = scaling.get("attention_factor")
        if attn is None:
            attn = (np.sqrt(1 + np.log(factor) / np.log(orig))
                    if factor > 1.0 else 1.0)
        return (inv / ext).astype(np.float32), float(attn)
    raise NotImplementedError(f"rope_scaling type '{kind}' not supported")


def mla_rope_live(cfg: ModelConfig) -> int:
    """The width of the q_rot that ``_mla_attention`` hands the MLA kernels:
    qk_rope_head_dim rounded up to the kernels' 64-column step. The rope
    pages keep rope_cache_dim columns, zero past qk_rope_head_dim, and the
    kernels read only q_rot's width of them."""
    return min(cfg.rope_cache_dim, -(-cfg.qk_rope_head_dim // 64) * 64)


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """MLA attention scale: qk_head_dim^-0.5 times the YaRN mscale² that
    HF's DeepseekV2/V3 attention applies when rope_scaling carries
    mscale_all_dim."""
    scale = 1.0 / np.sqrt(cfg.qk_head_dim)
    s = cfg.rope_scaling or {}
    if s.get("mscale_all_dim"):
        factor = float(s.get("factor", 1.0))
        if factor > 1.0:
            m = 0.1 * float(s["mscale_all_dim"]) * np.log(factor) + 1.0
            scale *= m * m
    return float(scale)


def rope_tables(positions, inv_freq, attn_scale: float):
    """(cos, sin) [..., 1, hd/2] f32 for ``positions`` [...]: computed once
    per step and shared by every layer's q and k."""
    angles = positions[..., None].float() * inv_freq
    return (torch.cos(angles)[..., None, :] * attn_scale,
            torch.sin(angles)[..., None, :] * attn_scale)


def apply_rope(x, cos, sin):
    """Rotary embedding, llama half-split convention. x [..., N, hd]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x, positions, inv_freq, attn_scale: float):
    """Rotary embedding of x [..., N, hd] at positions [...]; inv_freq
    [hd/2] f32 tensor."""
    return apply_rope(x, *rope_tables(positions, inv_freq, attn_scale))


def layer_weight(lw: dict, name: str, i: int):
    """Layer ``i``'s ``name`` weight of the stack ``lw``: a tensor, or the
    layer's view ``{"q", "s"[, "z"]}`` of a quantized stack."""
    w = lw[name]
    if isinstance(w, dict):
        return {k: v[i] for k, v in w.items()}
    return w[i]


def _mm(x, w, matmul):
    """``x @ w``; a quantized ``w`` through ``matmul`` (the dequant-GEMM's
    wrapper, or its plain version)."""
    return matmul(x, w) if is_qtensor(w) else x @ w


def _mlp(h, w_gate, w_up, w_down, act: str = "silu",
         matmul: Callable = quant_matmul):
    g = _mm(h, w_gate, matmul)
    g = F.gelu(g, approximate="tanh") if act == "gelu_tanh" else F.silu(g)
    return _mm(g * _mm(h, w_up, matmul), w_down, matmul)


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: multiplying a
    tensor of that dtype by it is the JAX package's multiply by
    ``jnp.asarray(value, dtype)`` (and needs no device tensor, so a captured
    step can hold it)."""
    return float(torch.tensor(value, dtype=dtype))


def embed_tokens(cfg: ModelConfig, params, tokens):
    """The embedding rows of ``tokens``, times sqrt(D) rounded to their
    dtype when the model scales them (Gemma). Every embedding site goes
    through here; a tied head reads the unscaled table."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * _in_dtype(float(np.sqrt(cfg.hidden_size)), x.dtype)
    return x


def lm_logits(cfg: ModelConfig, params, x, out=None,
              matmul: Callable = quant_matmul):
    """f32 logits of hidden states ``x`` (into ``out``[:len(x)] when given),
    with the final logit softcap c·tanh(logits/c) in f32 (Gemma-2) applied in
    place. Every logits site goes through here; a quantized head through
    ``matmul``."""
    logits = _mm(x, _lm_head(cfg, params), matmul)
    logits = (logits.float() if out is None
              else out[:logits.shape[0]].copy_(logits))
    c = cfg.final_logit_softcap
    if c:
        logits.div_(c).tanh_().mul_(c)
    return logits


def layer_window(cfg: ModelConfig, li: int) -> int:
    """The sliding window of cache layer ``li``: its ``layer_windows``
    entry, else the model's ``sliding_window``; 0 = full attention."""
    if cfg.layer_windows is not None:
        return int(cfg.layer_windows[li])
    return int(cfg.sliding_window or 0)


def f32_sinks(params: dict) -> dict:
    """``params`` with every layer stack's sink logits in f32, the kernels'
    type (the values are the model dtype's, so nothing rounds): an engine
    converts them once here, and no step converts them again. The caller's
    dicts are left as they are; no other tensor is copied."""
    out = dict(params)
    for key in ("layers", "dense_layers"):
        lw = params.get(key)
        if lw is not None and "sink" in lw:
            out[key] = dict(lw, sink=lw["sink"].float())
    return out


def router_weights(xf, router_w, router_bias, cfg: ModelConfig):
    """Token→expert combine weights [N, E] f32, zero for unrouted experts
    (the JAX package's ``_router_weights``).

    - softmax: softmax over all expert logits (plus the router bias with
      ``router_logit_bias``), the top-k probabilities;
    - sigmoid: sigmoid scores; the choice adds the correction bias and,
      with n_group > 1, keeps the best ``topk_group`` groups by the sum of
      each group's top-2 choice scores (softmax groups score by their max);
      the weights are the raw scores at the chosen experts.
    Then optionally renormalised (``norm_topk_prob``) and scaled by
    ``routed_scaling_factor``."""
    N = xf.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xf @ router_w).float()  # [N, E]

    def group_mask(choice, group_score):
        G = cfg.n_group
        gi = torch.topk(group_score(choice.view(N, G, E // G)),
                        cfg.topk_group, dim=-1).indices
        keep = torch.zeros((N, G), dtype=torch.bool, device=xf.device)
        keep.scatter_(1, gi, True)
        return torch.where(keep.repeat_interleave(E // G, dim=1), choice,
                           torch.zeros_like(choice))

    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores + router_bias[None, :]
        if cfg.n_group > 1:
            choice = group_mask(
                choice, lambda g: torch.topk(g, 2, dim=-1).values.sum(-1))
    else:
        if cfg.router_logit_bias:
            logits = logits + router_bias[None, :]
        scores = torch.softmax(logits, dim=-1)
        choice = scores
        if cfg.n_group > 1:
            choice = group_mask(choice, lambda g: g.amax(-1))
    topi = torch.topk(choice, K, dim=-1).indices
    gates = torch.gather(scores, 1, topi)
    if cfg.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * cfg.routed_scaling_factor
    return torch.zeros((N, E), dtype=torch.float32,
                       device=xf.device).scatter_add_(1, topi, gates)


def mlp_moe(x, router_w, router_bias, w_gate, w_up, w_down,
            cfg: ModelConfig, matmul: Callable = quant_matmul):
    """Token-choice MoE over x [N, D], all experts computed for every token
    and combined with the router's weights (the JAX package's single-device
    ``_mlp_moe``): expert weights [E, D, Fm] / [E, Fm, D] (quantized
    stacks through ``matmul``'s batched form). The combine weights are cast
    to the expert output's dtype first, as there."""
    cw = router_weights(x, router_w, router_bias, cfg)
    h = _mm(x, w_gate, matmul)  # [E, N, Fm]
    u = _mm(x, w_up, matmul)
    y = _mm(F.silu(h) * u, w_down, matmul)  # [E, N, D]
    return torch.einsum("end,ne->nd", y, cw.to(y.dtype))


# ---------------------------------------------------------------------------
# The layer stack
# ---------------------------------------------------------------------------


class _Rope:
    """inv_freq of ``cfg`` per device, built once: head_dim wide for GQA,
    qk_rope_head_dim wide for MLA."""

    def __init__(self, cfg: ModelConfig):
        dim = cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
        self.inv_np, self.attn_scale = rope_params(cfg.rope_theta, dim,
                                                   cfg.rope_scaling)
        self._inv: dict = {}

    def tables(self, positions):
        dev = positions.device
        inv = self._inv.get(dev)
        if inv is None:
            inv = self._inv[dev] = torch.from_numpy(self.inv_np).to(dev)
        return rope_tables(positions, inv, self.attn_scale)


def _gqa_attention(cfg, lw, i, li, h, cos, sin, slots, k_cache, v_cache,
                   attend, matmul):
    """GQA attention of layer ``i`` of stack ``lw`` (cache layer ``li``), in
    the JAX forward's order: q/k/v (plus their biases), the per-head q/k
    RMSNorm, RoPE, q times sqrt(hd / query_pre_attn_scalar), the KV write,
    ``attend(li, q [N, H, hd], sinks [H] or None)``, wo (plus its bias) and
    the post-attention norm."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    N = h.shape[0]
    q, k, v = (_mm(h, layer_weight(lw, name, i), matmul)
               for name in ("wq", "wk", "wv"))
    if "bq" in lw:
        q, k, v = q + lw["bq"][i], k + lw["bk"][i], v + lw["bv"][i]
    q, k, v = q.view(N, H, hd), k.view(N, KV, hd), v.view(N, KV, hd)
    if cfg.qk_norm:  # Qwen3: per-head RMSNorm before RoPE
        q = rms_norm(q, lw["q_norm"][i], eps)
        k = rms_norm(k, lw["k_norm"][i], eps)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cfg.query_pre_attn_scalar is not None:
        # Gemma-2 scores scale by qpas^-0.5, the kernels by hd^-0.5
        q = q * _in_dtype(float(np.sqrt(hd / cfg.query_pre_attn_scalar)),
                          q.dtype)
    write_kv(k_cache, v_cache, li, slots, k, v)
    out = _mm(attend(li, q, lw["sink"][i] if "sink" in lw else None)
              .reshape(N, H * hd), layer_weight(lw, "wo", i), matmul)
    if "bo" in lw:
        out = out + lw["bo"][i]
    if cfg.sandwich_norms:  # Gemma-2: post-norm on the sublayer output
        out = rms_norm(out, lw["post_attn_norm"][i], eps)
    return out


def _mla_attention(cfg, lw, i, li, h, cos, sin, slots, k_cache, v_cache,
                   attend, matmul):
    """Multi-head latent attention (the JAX package's ``_mla_attention``,
    weight-absorbed): q through wq (or q_a → RMSNorm → q_b); kv_a gives the
    RMSNorm'd latent c and the rotated k_rot, written at ``slots`` (k_rot
    zero-padded to rope_cache_dim); q_eff = q_nope·W_UK in f32;
    ``attend(li, q_eff [N, H, r], q_rot [N, H, prl])`` (both f32, q_rot
    zero-padded to prl = :func:`mla_rope_live`, the rope columns the
    attention reads) returns the latent output [N, H, r], expanded through
    W_UV and wo."""
    H, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv, pr = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.rope_cache_dim
    eps = cfg.rms_norm_eps
    N = h.shape[0]
    def mm(x, name):
        return _mm(x, layer_weight(lw, name, i), matmul)

    if "q_b" in lw:
        q = mm(rms_norm(mm(h, "q_a"), lw["q_a_norm"][i], eps), "q_b")
    else:
        q = mm(h, "wq")
    q = q.view(N, H, dn + dr)
    q_rot = apply_rope(q[..., dn:], cos, sin)
    ckv = mm(h, "kv_a")  # [N, r + dr]
    c = rms_norm(ckv[:, :r], lw["kv_a_norm"][i], eps)
    k_rot = apply_rope(ckv[:, None, r:], cos, sin)  # [N, 1, dr]
    write_kv(k_cache, v_cache, li, slots, c.view(N, 1, r),
             F.pad(k_rot, (0, pr - dr)))
    w_uk = lw["w_uk"][i].view(r, H, dn).float()
    q_eff = torch.einsum("nhd,rhd->nhr", q[..., :dn].float(), w_uk)
    o_lat = attend(li, q_eff.contiguous(),
                   F.pad(q_rot.float(), (0, mla_rope_live(cfg) - dr)))
    w_uv = lw["w_uv"][i].view(r, H, dv).float()
    out = torch.einsum("nhr,rhd->nhd", o_lat.float(), w_uv)
    return mm(out.reshape(N, H * dv).to(h.dtype), "wo")


def _layers(cfg: ModelConfig, params, x, cos, sin, slot_map, k_cache,
            v_cache, attend, matmul: Callable = quant_matmul):
    """The decoder stack over N flat tokens: x [N, D] embeddings, cos/sin
    their RoPE tables, K/V (or MLA's latent and rope part) written at
    ``slot_map`` [N] (int64) of the cache in place; ``attend`` is the
    layer's attention call (see ``_gqa_attention`` / ``_mla_attention``).
    A MoE model's dense prefix (``dense_layers``) comes first. The dense
    MLP takes the model's activation and, with sandwich norms, its post-MLP
    norm (as the JAX forward's, not the MoE's). Quantized weights go
    through ``matmul``. Returns the final-normed hidden states [N, D]."""
    eps = cfg.rms_norm_eps
    attention = _mla_attention if cfg.is_mla else _gqa_attention
    k_dense = cfg.num_dense_prefix_layers
    stacks = [(params["layers"], k_dense, cfg.num_layers - k_dense,
               cfg.is_moe)]
    if k_dense:
        stacks.insert(0, (params["dense_layers"], 0, k_dense, False))
    for lw, base, n, moe in stacks:
        for i in range(n):
            h = rms_norm(x, lw["attn_norm"][i], eps)
            x = x + attention(cfg, lw, i, base + i, h, cos, sin, slot_map,
                              k_cache, v_cache, attend, matmul)
            h = rms_norm(x, lw["mlp_norm"][i], eps)
            mlp_w = [layer_weight(lw, n, i)
                     for n in ("w_gate", "w_up", "w_down")]
            if moe:
                x = x + mlp_moe(h, lw["router"][i], lw["router_bias"][i],
                                *mlp_w, cfg, matmul)
                if cfg.n_shared_experts:  # dense shared experts on top
                    x = x + _mlp(h, *(layer_weight(lw, n, i) for n in (
                        "ws_gate", "ws_up", "ws_down")), matmul=matmul)
            else:
                out = _mlp(h, *mlp_w, cfg.hidden_activation, matmul)
                if cfg.sandwich_norms:  # Gemma-2 post-norm on the MLP output
                    out = rms_norm(out, lw["post_mlp_norm"][i], eps)
                x = x + out
    return rms_norm(x, params["final_norm"], eps)


def _lm_head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]


def mla_layer_pages(k_cache, v_cache, li: int):
    """(latent [slots, r], rope [slots, pr], c_scales, r_scales) of cache
    layer ``li``: views of the MLA caches [L, slots, 1, r] / [L, slots, 1,
    pr]; an int8 cache's pages with each stream's scales [slots, 1] (scale
    slot base 0), a plain cache's with None."""
    (lat, cs), (rp, rs) = layer_pages(k_cache, li), layer_pages(v_cache, li)
    return lat.flatten(1), rp.flatten(1), cs, rs


# ---------------------------------------------------------------------------
# MLA attention over the packed ragged batch
# ---------------------------------------------------------------------------


def mla_attention_seg(q_eff, q_rot, latent, rope_pages, block_tables,
                      positions, kv_lens, *, block_size: int, scale: float,
                      c_scales=None, r_scales=None, seg_keys: int = 128):
    """Latent-space attention of q_eff [B, S, H, r] / q_rot [B, S, H, prl]
    (f32; the first prl rope columns enter the scores) over each row's
    pages, the key axis walked in segments of ``seg_keys`` with an online
    softmax (the JAX package's ``_mla_attention_seg``): scores q_eff·c +
    q_rot·k_rot, value c, keys at or before each query's position and below
    kv_len; int8 pages dequantize in f32 with ``c_scales``/``r_scales``
    (scale slot base 0). Returns o_lat [B, S, H, r] f32.

    The walk covers the whole table width W (a fully masked segment leaves
    the running max, sum and output as they are), so no bound is read on
    the host. Transient memory per segment: the scores [B, H, S, SEG] and
    the gathered latent [B, SEG, r], f32: at DeepSeek-V2-Lite width (H 16,
    r 512) and a 2048-token bucket (B = 68 chunk-grid tiles of S = 32
    tokens, SEG = 128), 17.8 MB each, beside the running output
    [B, H, S, r] of 71.3 MB."""
    B, S, H, r = q_eff.shape
    W = block_tables.shape[1]
    bs = block_size
    dev = q_eff.device
    spp = max(1, min(W, -(-seg_keys // bs)))
    SEG = spp * bs
    nseg = -(-W // spp)
    bt = F.pad(block_tables.long(), (0, nseg * spp - W))
    # queries as [B, H*S, .] rows, so every product is one batched matmul
    # against the row's gathered segment
    qe = (q_eff.permute(0, 2, 1, 3) * scale).reshape(B, H * S, r)
    qr = (q_rot.permute(0, 2, 1, 3) * scale).reshape(B, H * S, -1)
    pos = positions.long()[:, :, None]
    lens = kv_lens.long()[:, None, None]
    m = torch.full((B, H, S), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H * S, r), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    for s in range(nseg):
        slot_idx = (bt[:, s * spp:(s + 1) * spp, None] * bs
                    + offs).reshape(B, SEG)
        cg, krg = gather_latent(latent, rope_pages, slot_idx, c_scales,
                                r_scales)  # [B, SEG, r], [B, SEG, pr]
        sc = (torch.bmm(qe, cg.transpose(1, 2))
              + torch.bmm(qr, krg[..., :qr.shape[-1]].transpose(1, 2))
              ).view(B, H, S, SEG)
        key_pos = s * SEG + torch.arange(SEG, device=dev)
        mask = (key_pos <= pos) & (key_pos < lens)  # [B, S, SEG]
        sc = sc.masked_fill(~mask[:, None], _NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = (acc * corr.view(B, H * S, 1)
               + torch.bmm(p.view(B, H * S, SEG), cg))
        m = m_new
    out = acc.view(B, H, S, r) / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3)  # [B, S, H, r]


def mla_chunk_attention(q_eff, q_rot, latent, rope_pages, block_tables,
                        positions, kv_lens, *, block_size: int, scale: float,
                        c_scales=None, r_scales=None):
    """The chunk grid's MLA attention: q_eff [C, S, H, r] / q_rot [C, S, H,
    prl] f32 of tiles whose tokens sit at consecutive ``positions`` [C, S]
    from column 0 on. CUDA tensors go through the MLA flash-prefill kernel
    (``flash_mla_prefill_paged``, pos_base = each tile's column 0), CPU
    tensors through :func:`mla_attention_seg`, the JAX package's own walk.
    Returns o_lat [C, S, H, r] f32; a tile's columns past its tokens are
    unspecified."""
    kw = dict(block_size=block_size, scale=scale, c_scales=c_scales,
              r_scales=r_scales)
    if q_eff.device.type == "cuda":
        return flash_mla_prefill_paged(
            q_eff, q_rot, latent, rope_pages, block_tables,
            positions[:, 0].to(torch.int32).contiguous(),
            kv_lens.to(torch.int32).contiguous(), **kw)
    return mla_attention_seg(q_eff, q_rot, latent, rope_pages, block_tables,
                             positions, kv_lens, **kw)


def mla_ragged_olat(q_eff, q_rot, latent, rope_pages, block_tables,
                    positions, rows3, grid_row, grid_col, grid_rows, *,
                    block_size: int, scale: float, decode: Callable,
                    chunk: Callable = mla_chunk_attention, c_scales=None,
                    r_scales=None):
    """Ragged MLA attention (the JAX package's ``_mla_ragged_olat``): q_eff
    [T, H, r] / q_rot [T, H, pr] f32 → o_lat [T, H, r] f32.

    - Every row goes through ``decode`` (the latent-decode kernel wrapper or
      its plain version) in ONE call, its query the row's first token;
      rows whose q_len is not 1 see kv_len 0, so they cost nothing and
      their (zero) output lands in a dump slot.
    - Chunk tokens scatter into the [C, RAGGED_TILE] chunk grid
      (``grid_row``/``grid_col`` per token, ``grid_rows`` per tile) and go
      through ``chunk`` (:func:`mla_chunk_attention`, or
      :func:`mla_attention_seg` to run the walk on any device) in one call;
      tiles that hold no token see kv_len 0. ``grid_rows`` None skips them
      (a plan with decode rows only).
    int8 pages pass each stream's scales (scale slot base 0)."""
    T, H, r = q_eff.shape
    q_start, q_len, kv_lens = rows3[:, 0], rows3[:, 1], rows3[:, 2]
    is_dec = q_len == 1
    dec_idx = torch.where(is_dec, q_start, T).long()
    qe_pad = F.pad(q_eff, (0, 0, 0, 0, 0, 1))
    qr_pad = F.pad(q_rot, (0, 0, 0, 0, 0, 1))
    scales = dict(c_scales=c_scales, r_scales=r_scales)
    dec = decode(qe_pad[dec_idx], qr_pad[dec_idx], latent, rope_pages,
                 block_tables, torch.where(is_dec, kv_lens,
                                           torch.zeros_like(kv_lens)),
                 block_size=block_size, scale=scale, **scales)  # [R, H, r]
    out = torch.zeros((T + 1, H, r), dtype=torch.float32,
                      device=q_eff.device)
    out[dec_idx] = dec.float()
    out = out[:T]
    if grid_rows is None:
        return out
    C = grid_rows.shape[0]
    S_C = min(RAGGED_TILE, T)
    gr, gc = grid_row.long(), grid_col.long()

    def to_grid(x):
        g = x.new_zeros((C + 1, S_C, *x.shape[1:]))
        g[gr, gc] = x
        return g[:C]

    # tiles that hold no token (the grid's spare rows) see no key
    used = torch.zeros((C + 1,), dtype=torch.bool,
                       device=q_eff.device).index_fill_(0, gr, True)[:C]
    g_out = chunk(
        to_grid(q_eff), to_grid(q_rot), latent, rope_pages,
        block_tables[grid_rows.long()], to_grid(positions),
        torch.where(used, kv_lens[grid_rows.long()], 0),
        block_size=block_size, scale=scale, **scales)
    vals = F.pad(g_out, (0, 0, 0, 0, 0, 0, 0, 1))[gr, gc]  # [T, H, r]
    return torch.where((gr < C)[:, None, None], vals, out)


# ---------------------------------------------------------------------------
# The ragged step
# ---------------------------------------------------------------------------


def _make_ragged_forward(cfg: ModelConfig, block_size: int,
                         attention: Optional[Callable],
                         chunk_attention: Callable,
                         matmul: Callable = quant_matmul):
    """The packed ragged forward that the step and the verify share:
    ``forward(params, ints5, rows3, grid_rows, block_tables, k_cache,
    v_cache) -> x [T, D]``, the final-normed hidden state of every packed
    token, the caches written in place; see :func:`make_ragged_step_fn` for
    the operands and the attention calls."""
    check_supported(cfg)
    rope_ = _Rope(cfg)
    if attention is None:
        attention = mla_paged_decode if cfg.is_mla else ragged_paged_attention
    scale = mla_softmax_scale(cfg) if cfg.is_mla else None

    def forward(params, ints5, rows3, grid_rows, block_tables, k_cache,
                v_cache):
        cos, sin = rope_.tables(ints5[1])

        if cfg.is_mla:
            def attend(li, q_eff, q_rot):
                lat, rp, cs, rs = mla_layer_pages(k_cache, v_cache, li)
                return mla_ragged_olat(
                    q_eff, q_rot, lat, rp, block_tables, ints5[1], rows3,
                    ints5[3], ints5[4], grid_rows,
                    block_size=block_size, scale=scale,
                    decode=attention,
                    chunk=chunk_attention, c_scales=cs, r_scales=rs)
        else:
            def attend(li, q, sinks):
                kc, ks = layer_pages(k_cache, li)
                vc, vs = layer_pages(v_cache, li)
                return attention(q, kc, vc, block_tables, rows3,
                                 block_size=block_size,
                                 window=layer_window(cfg, li), sinks=sinks,
                                 k_scales=ks, v_scales=vs,
                                 softcap=cfg.attn_logit_softcap)

        return _layers(cfg, params, embed_tokens(cfg, params, ints5[0]), cos,
                       sin, ints5[2].long(), k_cache, v_cache, attend, matmul)

    return forward


def make_ragged_step_fn(cfg: ModelConfig, block_size: int,
                        attention: Optional[Callable] = None,
                        chunk_attention: Callable = mla_chunk_attention,
                        matmul: Callable = quant_matmul):
    """The packed ragged engine step.

    ``fn(params, ints5 [5, T], rows3 [R, 3], grid_rows [C],
    block_tables [R, W], k_cache, v_cache, logits_out=None) -> (logits
    [R, V] f32, k_cache, v_cache)``: ``ints5`` stacks tokens / positions /
    slot_map / grid_row /
    grid_col, ``rows3`` holds (q_start, q_len, kv_len) per row (q_len 0 =
    padding row), caches are [L, slots, KV, hd] (or int8 ``{"q", "s"}``;
    MLA: the latent and rope caches) and are updated in place. Logits are
    taken at each row's last token. ``grid_rows`` None says the step has
    decode rows only: MLA then skips its chunk-grid walk (GQA reads no
    grid operand). ``logits_out``, an f32 [R, V] tensor, receives the logits
    and is returned (a captured step writes where its sampler reads).

    ``attention`` is the per-layer attention call: by default the kernel
    wrapper of the model's family (``ragged_paged_attention``, or
    ``mla_paged_decode`` for MLA decode rows), or its plain version
    (``ragged_attention_ref``, ``mla_paged_decode_ref``) to run the same
    step without the kernel. MLA chunk tokens go through
    ``chunk_attention``: :func:`mla_chunk_attention` (the MLA flash-prefill
    kernel on the card), or :func:`mla_attention_seg` to run them without
    it. An int8 cache passes each layer's pages with that layer's scales
    (scale slot base 0). Quantized weights go through ``matmul``: the
    dequant-GEMM's wrapper ``quant_matmul`` by default, or its plain version
    ``quant_matmul_ref``.
    """
    forward = _make_ragged_forward(cfg, block_size, attention,
                                   chunk_attention, matmul)

    def fn(params, ints5, rows3, grid_rows, block_tables, k_cache, v_cache,
           logits_out=None):
        T = ints5.shape[1]
        x = forward(params, ints5, rows3, grid_rows, block_tables, k_cache,
                    v_cache)
        last = (rows3[:, 0] + rows3[:, 1] - 1).clamp(0, T - 1).long()
        return (lm_logits(cfg, params, x[last], logits_out, matmul), k_cache,
                v_cache)

    return fn


def make_ragged_verify_fn(cfg: ModelConfig, block_size: int,
                          attention: Optional[Callable] = None,
                          chunk_attention: Callable = mla_chunk_attention,
                          masked: bool = False):
    """Speculative verification on the packed ragged layout (the JAX
    package's ``make_ragged_verify_fn``): each verify row is a ragged chunk
    of q_len = draft + 1 tokens ([newest token, draft...]), run through
    :func:`make_ragged_step_fn`'s forward, with the greedy argmax and its
    logprob taken at EVERY packed position; the host slices each row's
    window out of the flat result. Draft KV is written like any chunk's:
    slots past the accepted prefix hold garbage that kv_len keeps out of
    every later read, and the next real step overwrites.

    ``fn(params, ints5 [5, T], rows3 [R, 3], grid_rows [C], block_tables
    [R, W], [mask_words [T, ceil(V/32)],] k_cache, v_cache,
    logits_out=None) -> (ids [T] int32, logps [T] f32, k_cache,
    v_cache)``. ``masked`` adds ``mask_words`` (int32 views of the uint32
    words the host walks along each constrained row's draft; padding and
    free rows all ones): every position's logits are masked to its FSM
    state's tokens (``FSM_MASK_FILL``) before the ``log_softmax``.
    ``logits_out``, an f32 [T', V] buffer with T' >= T, receives the
    logits (one scratch buffer serves every verify bucket: the [T, V]
    logits never outlive the call). The attention arguments are
    :func:`make_ragged_step_fn`'s."""
    forward = _make_ragged_forward(cfg, block_size, attention,
                                   chunk_attention)

    def f(params, ints5, rows3, grid_rows, block_tables, k_cache, v_cache,
          mask_words=None, logits_out=None):
        x = forward(params, ints5, rows3, grid_rows, block_tables, k_cache,
                    v_cache)
        logits = lm_logits(cfg, params, x, logits_out)
        if mask_words is not None:
            logits = sampling.apply_mask_words(logits, mask_words)
        lp = torch.log_softmax(logits, dim=-1)
        ids = lp.argmax(dim=-1)
        chosen = lp.gather(1, ids[:, None])[:, 0]
        return ids.to(torch.int32), chosen, k_cache, v_cache

    if masked:
        def fn(params, ints5, rows3, grid_rows, block_tables, mask_words,
               k_cache, v_cache, logits_out=None):
            return f(params, ints5, rows3, grid_rows, block_tables, k_cache,
                     v_cache, mask_words=mask_words, logits_out=logits_out)
    else:
        def fn(params, ints5, rows3, grid_rows, block_tables, k_cache,
               v_cache, logits_out=None):
            return f(params, ints5, rows3, grid_rows, block_tables, k_cache,
                     v_cache, logits_out=logits_out)
    return fn


def make_multi_decode_fn(cfg: ModelConfig, block_size: int, num_steps: int,
                         fsm: bool = False,
                         attention: Optional[Callable] = None):
    """K = ``num_steps`` chained decode steps in one call: the port of the
    JAX package's ``multi_decode`` in its packed ragged layout (one token a
    row, R rows), through :func:`make_ragged_step_fn`'s forward and the
    sampler. Nothing is read on the host between the steps, so on the card
    the whole burst is one captured graph.

    ``fn(params, ints3 [3, R], rows [5, R], block_tables [R, W], k_cache,
    v_cache, branches, states=None, mask_table=None, next_table=None) ->
    (tokens [K, R] int64, logps [K, R] f32)``:

    - ``ints3`` (int32) holds each row's newest token (its KV not yet
      written), that token's position and the row's kv_len (0: a padding
      row); ``block_tables`` must already cover position + K - 1;
    - ``rows`` is ``sampling.pack_rows``' layout (temperature, top_k,
      top_p, seed, step0) on the device, ``branches`` the host arrays
      (temperature, top_k, top_p) that decide the sampler's branches;
    - step k writes its token's KV at position + k (a block index past the
      table goes to the null block), attends with kv_len + k (a padding
      row then reads the null block, as in the JAX package), draws with
      the key (seed, step0 + k), and feeds its tokens to step k + 1;
    - ``fsm`` masks every step with the FSM tables and carries the states
      (``sampling.sample_masked``; state 0 is the free row).
    """
    step = make_ragged_step_fn(cfg, block_size, attention)
    bs = block_size

    def fn(params, ints3, rows, block_tables, k_cache, v_cache, branches,
           states=None, mask_table=None, next_table=None):
        R, W = block_tables.shape
        dev = ints3.device
        tok, pos, kv = ints3[0], ints3[1], ints3[2]
        idx = torch.arange(R, dtype=torch.int32, device=dev)
        zero = torch.zeros((R,), dtype=torch.int32, device=dev)
        toks, logps = [], []
        for k in range(num_steps):
            blk = torch.div(pos, bs, rounding_mode="floor")
            page = block_tables.gather(1, blk.clamp_max(W - 1).long()[:, None])
            page = torch.where(blk < W, page[:, 0], NULL_BLOCK)
            ints5 = torch.stack([tok.to(torch.int32), pos,
                                 page * bs + pos % bs, zero, zero])
            rows3 = torch.stack([idx, (kv > 0).to(torch.int32), kv], dim=1)
            logits, _, _ = step(params, ints5, rows3, None, block_tables,
                                k_cache, v_cache)
            rows_k = torch.cat([rows[:4], rows[4:] + k])
            if fsm:
                tok, lp, states = sampling.sample_masked(
                    logits, *branches, None, states, mask_table, next_table,
                    rows=rows_k)
            else:
                tok, lp = sampling.sample(logits, *branches, None,
                                          rows=rows_k)
            toks.append(tok)
            logps.append(lp)
            pos, kv = pos + 1, kv + 1
        return torch.stack(toks), torch.stack(logps)

    return fn


def make_draft_fn(cfg: ModelConfig, block_size: int, draft_layers: int,
                  num_steps: int, attention: Optional[Callable] = None):
    """Layer-skip self-drafting (the JAX package's ``make_draft_fn``):
    ``num_steps`` greedy decode steps through only the first
    ``draft_layers`` layers and the shared final norm and LM head, chained
    on :func:`make_multi_decode_fn` with the layer stack sliced (views, no
    copies) and ``cfg`` cut to ``num_layers = draft_layers``.

    The draft model is the serving model's prefix: no second checkpoint,
    no second cache. Draft KV of layers < draft_layers lands in the draft
    tokens' real slots; the verify rewrites every layer of those slots, and
    kv_len keeps a rejected slot out of every later read.

    ``fn(params, ints3 [3, R], block_tables [R, W], k_cache, v_cache) ->
    tokens [K, R] int64``, ``ints3`` and ``block_tables`` as for the burst.
    A model with a dense prefix (``num_dense_prefix_layers``, DeepSeek) has
    no uniform stack to cut and is refused, as is a depth outside (0,
    num_layers]: the full depth is allowed, the sharpest check of the draft
    KV's plumbing (the draft is then the model)."""
    if cfg.num_dense_prefix_layers:
        raise ValueError("layer-skip drafting needs a uniform layer stack "
                         "(num_dense_prefix_layers == 0)")
    if not 0 < draft_layers <= cfg.num_layers:
        raise ValueError(
            f"draft_layers={draft_layers} outside (0, {cfg.num_layers}]")
    cfg_d = dataclasses.replace(
        cfg, num_layers=draft_layers,
        layer_windows=(cfg.layer_windows[:draft_layers]
                       if cfg.layer_windows is not None else None))
    burst = make_multi_decode_fn(cfg_d, block_size, num_steps,
                                 attention=attention)

    def fn(params, ints3, block_tables, k_cache, v_cache):
        R = ints3.shape[1]
        pd = dict(params)
        pd["layers"] = {k: slice_layers(v, draft_layers)
                        for k, v in params["layers"].items()}
        # greedy: the sampler reads no row operand but the key's step
        rows = torch.zeros((5, R), dtype=torch.int32, device=ints3.device)
        greedy = (np.zeros((R,), np.float32), np.zeros((R,), np.int32),
                  np.ones((R,), np.float32))
        toks, _ = burst(pd, ints3, rows, block_tables, k_cache, v_cache,
                        greedy)
        return toks

    return fn


# ---------------------------------------------------------------------------
# The dense forward and embeddings
# ---------------------------------------------------------------------------


def make_forward_fn(cfg: ModelConfig, block_size: int,
                    attention: Optional[Callable] = None,
                    decode_attention: Optional[Callable] = None):
    """The non-ragged forward of [B, S] batches.

    ``fn(params, tokens [B, S], positions [B, S], slot_map [B, S],
    block_tables [B, W], kv_lens [B], last_idx [B], k_cache, v_cache,
    return_hidden=False)`` → ``(logits [B, V] f32 at last_idx, k_cache,
    v_cache)``, or with ``return_hidden`` the final-normed hidden states
    ``[B, S, D]`` f32 in place of the logits. Each row's tokens are
    consecutive positions from ``positions[b, 0]``; K/V is written at
    ``slot_map`` (padding → the null block).

    S > 1 attends through ``attention`` over the row's pages below
    ``kv_lens``: by default ``flash_prefill_paged`` (GQA; its dense call is
    the flash kernel wrapper) or ``flash_mla_prefill_paged`` (MLA: the MLA
    flash-prefill kernel reads the layer's pages itself), or their plain
    versions. S == 1 is a decode step over each row's pages below
    ``kv_lens``, through ``decode_attention``: by default
    ``paged_attention_decode`` (GQA) or ``mla_paged_decode`` (MLA), or
    their plain versions. Int8 caches pass each layer's scales.
    """
    check_supported(cfg)
    H, hd = cfg.num_heads, cfg.head_dim
    rope_ = _Rope(cfg)
    if attention is None:
        attention = (flash_mla_prefill_paged if cfg.is_mla
                     else flash_prefill_paged)
    if decode_attention is None:
        decode_attention = (mla_paged_decode if cfg.is_mla
                            else paged_attention_decode)
    scale = mla_softmax_scale(cfg) if cfg.is_mla else None

    def fn(params, tokens, positions, slot_map, block_tables, kv_lens,
           last_idx, k_cache, v_cache, return_hidden: bool = False):
        B, S = tokens.shape
        cos, sin = rope_.tables(positions.reshape(B * S))
        lens = kv_lens.to(torch.int32)

        if cfg.is_mla:
            pos_base = positions[:, 0].to(torch.int32).contiguous()

            def attend(li, q_eff, q_rot):
                lat, rp, cs, rs = mla_layer_pages(k_cache, v_cache, li)
                kw = dict(block_size=block_size, scale=scale, c_scales=cs,
                          r_scales=rs)
                if S == 1:
                    return decode_attention(q_eff, q_rot, lat, rp,
                                            block_tables, lens, **kw)
                o = attention(q_eff.view(B, S, H, -1),
                              q_rot.view(B, S, H, -1), lat, rp,
                              block_tables, pos_base, lens, **kw)
                return o.view(B * S, H, -1)
        elif S == 1:
            # the kernel's rows, made once for every layer
            rows3 = decode_rows(lens)

            def attend(li, q, sinks):
                kc, ks = layer_pages(k_cache, li)
                vc, vs = layer_pages(v_cache, li)
                return decode_attention(q, kc, vc, block_tables, lens,
                                        block_size=block_size,
                                        window=layer_window(cfg, li),
                                        sinks=sinks, k_scales=ks,
                                        v_scales=vs, rows3=rows3,
                                        softcap=cfg.attn_logit_softcap)
        else:
            def attend(li, q, sinks):
                return attention(q.view(B, S, H, hd), k_cache, v_cache, li,
                                 block_tables, positions, kv_lens,
                                 block_size=block_size,
                                 sliding_window=layer_window(cfg, li),
                                 sinks=sinks,
                                 softcap=cfg.attn_logit_softcap)

        x = _layers(cfg, params, embed_tokens(cfg, params,
                                              tokens.reshape(B * S)), cos,
                    sin, slot_map.reshape(B * S).long(), k_cache, v_cache,
                    attend).view(B, S, -1)
        if return_hidden:  # embeddings: pooled downstream, no lm head
            return x.float(), k_cache, v_cache
        x_last = x[torch.arange(B, device=x.device), last_idx.long()]
        return lm_logits(cfg, params, x_last), k_cache, v_cache

    return fn


def make_embed_fn(cfg: ModelConfig, block_size: int,
                  attention: Optional[Callable] = None):
    """Mean-pooled, L2-normalised sequence embeddings over the dense
    forward: ``f(params, tokens [B, S], lengths [B], k_cache, v_cache) →
    [B, D] f32``. S must be a multiple of ``block_size``; the scratch
    caches need B·S/block_size + 1 blocks (block 0 is the null block), laid
    out contiguously as row b's block w = 1 + b·W + w, and their contents
    are irrelevant between calls. Padding rows (length 0) see no key and
    pool to zeros. ``attention`` is the S > 1 attention of
    :func:`make_forward_fn` (None: the family's kernel wrapper)."""
    forward = make_forward_fn(cfg, block_size, attention)

    def f(params, tokens, lengths, k_cache, v_cache):
        B, S = tokens.shape
        W = S // block_size
        dev = tokens.device
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
        bt = (1 + torch.arange(B, device=dev)[:, None] * W
              + torch.arange(W, device=dev)[None, :])
        slot_map = (bt[:, :, None] * block_size
                    + torch.arange(block_size, device=dev)).reshape(B, S)
        lengths = lengths.to(torch.int32)
        # a padded row attends only keys below its length, so junk past it
        # never reaches a valid position; pooling masks it anyway
        x, _, _ = forward(params, tokens, positions, slot_map,
                          bt.to(torch.int32), lengths,
                          torch.zeros((B,), dtype=torch.int32, device=dev),
                          k_cache, v_cache, return_hidden=True)
        valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        pooled = (x * valid[..., None]).sum(1) / torch.clamp_min(
            lengths[:, None].float(), 1.0)
        return pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)

    return f
