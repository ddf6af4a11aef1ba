"""Llama-family forward pass over a paged KV cache, in PyTorch.

The port of the dense paths of ``dynamo_tpu/engine/model.py``:

- ``make_ragged_step_fn`` (``forward(ragged=...)``): one call is one engine
  step; every prefill chunk and decode row of a scheduler plan rides one
  packed token batch, and attention runs through the ragged paged kernel
  (ops/ragged_attention.py).
- ``make_forward_fn`` (``forward(ragged=None)``) for [B, S] prefill
  batches, attention through the flash prefill kernel
  (ops/flash_prefill.py), and ``make_embed_fn`` on top of it: mean-pooled
  sequence embeddings.

Both write K/V into a plain or an int8 cache (engine/cache.py) and share
one layer stack.

Differences from the JAX package, each deliberate:

- Layers run in a Python loop over the stacked ``[L, ...]`` weights in
  place of ``lax.scan``; PyTorch runs eagerly, so no program is compiled
  per token bucket.
- The KV write is an in-place ``index_copy_`` into the caller's cache at
  ``slot_map`` (padding tokens write into the null block, as in JAX); an
  int8 cache stores ``quantize_kv`` of k and v. It replaces buffer
  donation: the returned caches are the tensors passed in.
- The chunk-grid operands exist only for the JAX package's XLA
  decomposition; the step accepts them and does not read them.
- Plain Llama GQA only. Every other ``ModelConfig`` switch raises
  ``NotImplementedError`` when the step is built.

Weights keep the JAX layout ``[in, out]``, so each projection is
``x @ W`` exactly as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.cache import layer_pages, write_kv
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.ops.flash_prefill import flash_prefill_paged
from dynamo_tpu_torch.ops.ragged_attention import (
    HEAD_DIMS, MAX_GROUP, ragged_paged_attention,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the port serves {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every architecture switch the port's forward lacks."""
    unsupported = {
        "MoE (num_experts)": cfg.is_moe,
        "MLA (kv_lora_rank)": cfg.is_mla,
        "qkv_bias": cfg.qkv_bias,
        "qk_norm": cfg.qk_norm,
        "o_bias": cfg.o_bias,
        "sliding_window": bool(cfg.sliding_window),
        "layer_windows": cfg.layer_windows is not None,
        "attention_sinks": cfg.attention_sinks,
        "embed_scale": cfg.embed_scale,
        "hidden_activation": cfg.hidden_activation != "silu",
        "attn_logit_softcap": bool(cfg.attn_logit_softcap),
        "final_logit_softcap": bool(cfg.final_logit_softcap),
        "sandwich_norms": cfg.sandwich_norms,
        "query_pre_attn_scalar": cfg.query_pre_attn_scalar is not None,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            "the torch port serves plain Llama GQA only; not yet ported: "
            + ", ".join(bad) + " (ROADMAP A2, A9, A10)")


def check_kernel_geometry(cfg: ModelConfig) -> None:
    """Raise unless the port's CUDA attention kernels take this model's
    heads: head_dim in HEAD_DIMS and a GQA group of at most MAX_GROUP. An
    engine on the card checks this when it is built, so no step routes
    around a kernel at run time."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hd not in HEAD_DIMS or H % KV or H // KV > MAX_GROUP:
        raise ValueError(
            f"the CUDA attention kernels take head_dim in {HEAD_DIMS} and "
            f"H / KV <= {MAX_GROUP}; this model has head_dim {hd}, H {H}, "
            f"KV {KV}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
#
# params = {
#   "embed": [V, D],
#   "layers": {"attn_norm": [L, D], "mlp_norm": [L, D],
#              "wq": [L, D, H*hd], "wk": [L, D, KV*hd], "wv": [L, D, KV*hd],
#              "wo": [L, H*hd, D],
#              "w_gate": [L, D, F], "w_up": [L, D, F], "w_down": [L, F, D]},
#   "final_norm": [D], "lm_head": [D, V] (absent when tied)
# }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random weights with the JAX package's shapes and scales: normal /
    sqrt(fan_in), norms one. Drawn from ``generator`` (which must live on
    ``device``), one layer at a time so the f32 draw never doubles the
    footprint of a full-width model."""
    check_supported(cfg)
    dtype = torch_dtype(cfg)
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    H, KV, hd, Fi = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.intermediate_size)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
                / float(np.sqrt(fan_in))).to(dtype)

    def stacked(shape, fan_in):
        out = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            out[i] = w(shape, fan_in)
        return out

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wq": stacked((D, H * hd), D),
        "wk": stacked((D, KV * hd), D),
        "wv": stacked((D, KV * hd), D),
        "wo": stacked((H * hd, D), H * hd),
        "w_gate": stacked((D, Fi), D),
        "w_up": stacked((D, Fi), D),
        "w_down": stacked((Fi, D), Fi),
    }
    params = {"embed": w((V, D), D), "layers": layers,
              "final_norm": torch.ones((D,), dtype=dtype, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((D, V), D)
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


def _mlp(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# The layer stack
# ---------------------------------------------------------------------------


class _Rope:
    """inv_freq of ``cfg`` per device, built once."""

    def __init__(self, cfg: ModelConfig):
        self.inv_np, self.attn_scale = rope_params(
            cfg.rope_theta, cfg.head_dim, cfg.rope_scaling)
        self._inv: dict = {}

    def tables(self, positions):
        dev = positions.device
        inv = self._inv.get(dev)
        if inv is None:
            inv = self._inv[dev] = torch.from_numpy(self.inv_np).to(dev)
        return rope_tables(positions, inv, self.attn_scale)


def _layers(cfg: ModelConfig, params, x, cos, sin, slot_map, k_cache,
            v_cache, attend):
    """The decoder stack over N flat tokens: x [N, D] embeddings, cos/sin
    their RoPE tables, K/V written at ``slot_map`` [N] (int64) of a plain
    or int8 cache in place; ``attend(li, q [N, H, hd]) -> [N, H, hd]`` is
    the layer's attention. Returns the final-normed hidden states [N, D]."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    N = x.shape[0]
    lw = params["layers"]
    for li in range(cfg.num_layers):
        h = rms_norm(x, lw["attn_norm"][li], eps)
        q = apply_rope((h @ lw["wq"][li]).view(N, H, hd), cos, sin)
        k = apply_rope((h @ lw["wk"][li]).view(N, KV, hd), cos, sin)
        v = (h @ lw["wv"][li]).view(N, KV, hd)
        write_kv(k_cache, v_cache, li, slot_map, k, v)
        x = x + attend(li, q).reshape(N, H * hd) @ lw["wo"][li]
        h = rms_norm(x, lw["mlp_norm"][li], eps)
        x = x + _mlp(h, lw["w_gate"][li], lw["w_up"][li], lw["w_down"][li])
    return rms_norm(x, params["final_norm"], eps)


def _lm_head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# The ragged step
# ---------------------------------------------------------------------------


def make_ragged_step_fn(cfg: ModelConfig, block_size: int,
                        attention: Callable = ragged_paged_attention):
    """The packed ragged engine step.

    ``fn(params, ints5 [5, T], rows3 [R, 3], grid_rows [C],
    block_tables [R, W], k_cache, v_cache) -> (logits [R, V] f32, k_cache,
    v_cache)``: ``ints5`` stacks tokens / positions / slot_map / grid_row /
    grid_col, ``rows3`` holds (q_start, q_len, kv_len) per row (q_len 0 =
    padding row), caches are [L, slots, KV, hd] (or int8 ``{"q", "s"}``)
    and are updated in place. Logits are taken at each row's last token.

    ``attention`` is the per-layer attention call: the kernel wrapper, or
    ``ragged_attention_ref`` to run the same step on the plain version. An
    int8 cache passes each layer's pages with that layer's scales (scale
    slot base 0).
    """
    check_supported(cfg)
    rope_ = _Rope(cfg)

    def fn(params, ints5, rows3, grid_rows, block_tables, k_cache, v_cache):
        del grid_rows  # XLA chunk-grid operand; not used by the kernel path
        T = ints5.shape[1]
        cos, sin = rope_.tables(ints5[1])

        def attend(li, q):
            kc, ks = layer_pages(k_cache, li)
            vc, vs = layer_pages(v_cache, li)
            return attention(q, kc, vc, block_tables, rows3,
                             block_size=block_size, k_scales=ks, v_scales=vs)

        x = _layers(cfg, params, params["embed"][ints5[0]], cos, sin,
                    ints5[2].long(), k_cache, v_cache, attend)
        last = (rows3[:, 0] + rows3[:, 1] - 1).clamp(0, T - 1).long()
        return (x[last] @ _lm_head(cfg, params)).float(), k_cache, v_cache

    return fn


# ---------------------------------------------------------------------------
# The dense forward and embeddings
# ---------------------------------------------------------------------------


def make_forward_fn(cfg: ModelConfig, block_size: int,
                    attention: Callable = flash_prefill_paged):
    """The non-ragged forward of [B, S] prefill batches.

    ``fn(params, tokens [B, S], positions [B, S], slot_map [B, S],
    block_tables [B, W], kv_lens [B], last_idx [B], k_cache, v_cache,
    return_hidden=False)`` → ``(logits [B, V] f32 at last_idx, k_cache,
    v_cache)``, or with ``return_hidden`` the final-normed hidden states
    ``[B, S, D]`` f32 in place of the logits. Each row's tokens are
    consecutive positions from ``positions[b, 0]``; K/V is written at
    ``slot_map`` (padding → the null block) and attention runs through
    ``attention`` (``flash_prefill_paged``, whose dense call is the kernel
    wrapper) over the row's pages below ``kv_lens``.

    S == 1 is the JAX package's paged decode kernel branch, which is not
    ported (ROADMAP B4).
    """
    check_supported(cfg)
    H, hd = cfg.num_heads, cfg.head_dim
    rope_ = _Rope(cfg)

    def fn(params, tokens, positions, slot_map, block_tables, kv_lens,
           last_idx, k_cache, v_cache, return_hidden: bool = False):
        B, S = tokens.shape
        if S == 1:
            raise NotImplementedError(
                "S == 1 takes the paged decode kernel, not ported yet "
                "(ROADMAP B4); decode through make_ragged_step_fn")
        cos, sin = rope_.tables(positions.reshape(B * S))

        def attend(li, q):
            return attention(q.view(B, S, H, hd), k_cache, v_cache, li,
                             block_tables, positions, kv_lens,
                             block_size=block_size)

        x = _layers(cfg, params, params["embed"][tokens.reshape(B * S)], cos,
                    sin, slot_map.reshape(B * S).long(), k_cache, v_cache,
                    attend).view(B, S, -1)
        if return_hidden:  # embeddings: pooled downstream, no lm head
            return x.float(), k_cache, v_cache
        x_last = x[torch.arange(B, device=x.device), last_idx.long()]
        return (x_last @ _lm_head(cfg, params)).float(), k_cache, v_cache

    return fn


def make_embed_fn(cfg: ModelConfig, block_size: int,
                  attention: Callable = flash_prefill_paged):
    """Mean-pooled, L2-normalised sequence embeddings over the dense
    forward: ``f(params, tokens [B, S], lengths [B], k_cache, v_cache) →
    [B, D] f32``. S must be a multiple of ``block_size``; the scratch
    caches need B·S/block_size + 1 blocks (block 0 is the null block), laid
    out contiguously as row b's block w = 1 + b·W + w, and their contents
    are irrelevant between calls. Padding rows (length 0) see no key and
    pool to zeros."""
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
