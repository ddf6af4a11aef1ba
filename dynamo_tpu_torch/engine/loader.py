"""Checkpoint loading: HF safetensors → the port's params dict, the port of
``dynamo_tpu/engine/loader.py``.

The weights land in the layout ``init_params`` draws (engine/model.py):
layers stacked on a leading L axis, projection matrices stored [in, out]
so the forward is ``x @ W``; ``load_hf_params`` equals
``params_from_jax(dynamo_tpu.engine.loader.load_hf_params(...))``.

Supported families: GQA decoders (Llama, Mistral, Phi-3's fused
projections, Mixtral's ``block_sparse_moe`` experts, Qwen2's q/k/v biases,
Qwen3 and Qwen3-MoE's q/k norms, Gemma-1 and Gemma-2 with their (1 + w)
norms folded in f32 and Gemma-2's four norms a layer; gpt-oss's attention
biases and sinks) and DeepSeek V2/V3 (MLA + MoE with shared experts and a
dense prefix; rope-interleaved checkpoints are de-interleaved once here so
the runtime rope is plain half-split). gpt-oss experts and MXFP4 blocks are
refused (ROADMAP A9), as is every other pre-quantized checkpoint, which the
JAX loader reads none of either.

``quantization`` ("int8", "int8-gN", "int4-gN": ``engine/quant.py``)
quantizes each matmul weight as it comes off the file, one layer (and one
expert) at a time, into stacked ``{"q", "s"}`` tensors: a bf16 checkpoint
never sits whole on the card, and the result equals ``quantize_params`` of
the unquantized load.

The port reads safetensors itself (``read_safetensors``): the 8-byte
little-endian header length, the JSON header, then each tensor as a view
of a copy-on-write ``mmap`` of the file, so a 16 GB checkpoint is never
copied through Python bytes. Each weight goes to the device as it is
stored, and is transposed and stacked there.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import struct
from contextlib import ExitStack
from typing import Optional

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model import check_supported, torch_dtype
from dynamo_tpu_torch.engine.quant import (
    empty_qtensor, is_qtensor, leaf_group, parse_spec, quantize,
    quantize_into,
)

logger = logging.getLogger("dynamo_torch.engine.loader")

#: safetensors dtype names → torch dtypes
ST_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64,
}


def read_safetensors(path: str, stack: ExitStack) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file as a CPU tensor viewing a
    copy-on-write map of the file; the map closes with ``stack``, so the
    caller copies what it keeps before then."""
    f = stack.enter_context(open(path, "rb"))
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.fstat(f.fileno()).st_size
    if not header:
        return {}
    mm = stack.enter_context(mmap.mmap(f.fileno(), 0,
                                       access=mmap.ACCESS_COPY))
    base = 8 + n
    out = {}
    for name, info in header.items():
        dtype = ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which the port does not read")
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= size - base:
            raise ValueError(f"{path}: tensor {name} lies outside the file")
        width = torch.empty(0, dtype=dtype).element_size()
        if (end - start) % width:
            raise ValueError(f"{path}: tensor {name} has a ragged byte size")
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - start,
                               offset=base + start)
        if (base + start) % width:
            raw = raw.clone()  # unaligned for its dtype: copy this one
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def _load_tensors(path: str, stack: ExitStack) -> dict[str, torch.Tensor]:
    """All ``*.safetensors`` under ``path``: {name: CPU tensor view}."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    out = {}
    for f in files:
        out.update(read_safetensors(f, stack))
    return out


def _deinterleave_rope_rows(w: torch.Tensor, starts, dr: int) -> torch.Tensor:
    """Permute rope-dim out-rows from interleaved to half-split layout.

    HF/DeepSeek checkpoints store rotary dims interleaved (re/im pairs); the
    runtime rope is half-split, so converting once at load (out[j] = in[2j],
    out[dr/2 + j] = in[2j + 1] within each rope row range) keeps the hot
    path free of per-step permutes. ``w`` is HF [out, in] (a copy of the
    checkpoint's); ``starts`` are the first rope row of each head's range.
    """
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]).to(
        w.device)
    for s in starts:
        w[s:s + dr] = w[s:s + dr][perm]
    return w


def _refuse_unported(raw_cfg: dict, names) -> None:
    if raw_cfg.get("quantization_config"):
        method = raw_cfg["quantization_config"].get("quant_method", "?")
        if str(method).lower() == "mxfp4":
            raise NotImplementedError(
                "quantized checkpoint (mxfp4): gpt-oss's MXFP4 experts are "
                "not ported to the torch loader yet (ROADMAP A9)")
        raise NotImplementedError(
            f"quantized checkpoint ({method}): the torch port reads "
            "unquantized checkpoints, as the JAX loader does (which reads "
            "no pre-quantized format but gpt-oss's MXFP4); load the "
            "unquantized weights with quantization='int8' / 'int8-gN' / "
            "'int4-gN' to quantize them on the card")
    for n in names:
        if n.endswith("experts.gate_up_proj_blocks") or n.endswith(
                "experts.gate_up_proj"):
            raise NotImplementedError(
                f"gpt-oss experts ({n}, MXFP4 or fused gate_up): not ported "
                "to the torch loader yet (ROADMAP A9)")


def load_hf_params(cfg: ModelConfig, path: str, device=None,
                   dtype: Optional[torch.dtype] = None,
                   quantization: Optional[str] = None) -> dict:
    """Map HF llama/mistral/phi-3/mixtral/qwen2/qwen3/gemma/gemma2/deepseek
    weight names onto the port's params dict, on ``device`` (None =
    "cuda") in ``dtype`` (None = the model's dtype; router biases and
    Gemma's folded norms stay f32), each matmul weight quantized as it is
    stacked when ``quantization`` is given."""
    check_supported(cfg)
    spec = parse_spec(quantization) if quantization else None
    device = torch.device(device or "cuda")
    dtype = dtype or torch_dtype(cfg)
    raw_cfg = {}
    cfg_file = os.path.join(path, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            raw_cfg = json.load(f)

    with ExitStack() as files:
        t = _load_tensors(path, files)
        _refuse_unported(raw_cfg, t)
        params = _build_params(cfg, t, raw_cfg, device, dtype, spec)
    return params


def _build_params(cfg: ModelConfig, t: dict, raw_cfg: dict, device,
                  dtype, spec=None) -> dict:
    def dev(name, as_dtype=dtype):
        """The checkpoint tensor on the device, as stored: a fresh copy
        (never a view of the file map)."""
        src = t[name]
        out = torch.empty(src.shape, dtype=as_dtype, device=device)
        out.copy_(src)
        return out

    L = cfg.num_layers
    k_dense = cfg.num_dense_prefix_layers
    H = cfg.num_heads

    def attn_layer(i: int, put) -> None:
        """``put(key, tensor, transpose)`` one layer's attention weights."""
        pre = f"model.layers.{i}.self_attn"
        if not cfg.is_mla:
            if f"{pre}.qkv_proj.weight" in t:
                # Phi-3/Phi-4 fuse q|k|v rows into one projection; split at
                # the head boundaries (rows are [H·hd | KV·hd | KV·hd])
                qkv = dev(f"{pre}.qkv_proj.weight")
                nq = cfg.num_heads * cfg.head_dim
                nkv = cfg.num_kv_heads * cfg.head_dim
                put("wq", qkv[:nq], True)
                put("wk", qkv[nq:nq + nkv], True)
                put("wv", qkv[nq + nkv:nq + 2 * nkv], True)
            else:
                for key, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                                  ("wv", "v_proj")):
                    put(key, dev(f"{pre}.{proj}.weight"), True)
            put("wo", dev(f"{pre}.o_proj.weight"), True)
            if cfg.qkv_bias:
                for key, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                                  ("bv", "v_proj")):
                    put(key, dev(f"{pre}.{proj}.bias"), False)
            if cfg.qk_norm:
                put("q_norm", dev(f"{pre}.q_norm.weight"), False)
                put("k_norm", dev(f"{pre}.k_norm.weight"), False)
            if cfg.o_bias:
                put("bo", dev(f"{pre}.o_proj.bias"), False)
            if cfg.attention_sinks:
                put("sink", dev(f"{pre}.sinks"), False)
            return
        # --- MLA (DeepSeek) ---
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        interleaved = raw_cfg.get("rope_interleave", True)
        kv_a = dev(f"{pre}.kv_a_proj_with_mqa.weight")  # [r+dr, D]
        if interleaved:
            kv_a = _deinterleave_rope_rows(kv_a, [r], dr)
        q_name = (f"{pre}.q_b_proj.weight" if cfg.q_lora_rank
                  else f"{pre}.q_proj.weight")
        q_w = dev(q_name)  # [H*(dn+dr), in]
        if interleaved:
            q_w = _deinterleave_rope_rows(
                q_w, [h * (dn + dr) + dn for h in range(H)], dr)
        kv_b = dev(f"{pre}.kv_b_proj.weight").reshape(H, dn + dv, r)
        put("kv_a", kv_a, True)
        put("kv_a_norm", dev(f"{pre}.kv_a_layernorm.weight"), False)
        put("w_uk", kv_b[:, :dn].permute(2, 0, 1).reshape(r, H * dn), False)
        put("w_uv", kv_b[:, dn:].permute(2, 0, 1).reshape(r, H * dv), False)
        put("wo", dev(f"{pre}.o_proj.weight"), True)
        if cfg.q_lora_rank:
            put("q_a", dev(f"{pre}.q_a_proj.weight"), True)
            put("q_a_norm", dev(f"{pre}.q_a_layernorm.weight"), False)
            put("q_b", q_w, True)
        else:
            put("wq", q_w, True)

    def dense_mlp_layer(i: int, put) -> None:
        pre = f"model.layers.{i}.mlp"
        if f"{pre}.gate_up_proj.weight" in t:
            # Phi-3/Phi-4 fuse gate|up (HF chunks: first half gate)
            gu = dev(f"{pre}.gate_up_proj.weight")  # [2F, D]
            F2 = gu.shape[0] // 2
            put("w_gate", gu[:F2], True)
            put("w_up", gu[F2:], True)
        else:
            put("w_gate", dev(f"{pre}.gate_proj.weight"), True)
            put("w_up", dev(f"{pre}.up_proj.weight"), True)
        put("w_down", dev(f"{pre}.down_proj.weight"), True)

    def moe_mlp_layer(i: int, put) -> None:
        E = cfg.num_experts
        if f"model.layers.{i}.block_sparse_moe.gate.weight" in t:  # mixtral
            pre = f"model.layers.{i}.block_sparse_moe"
            put("router", dev(f"{pre}.gate.weight"), True)
            put("router_bias", torch.zeros((E,), dtype=torch.float32,
                                           device=device), False)
            for key, n in (("w_gate", "w1"), ("w_down", "w2"),
                           ("w_up", "w3")):
                for e in range(E):
                    put(key, dev(f"{pre}.experts.{e}.{n}.weight"), True, e)
            return
        pre = f"model.layers.{i}.mlp"  # deepseek/qwen-moe style
        bias_name = f"{pre}.gate.e_score_correction_bias"
        put("router", dev(f"{pre}.gate.weight"), True)
        put("router_bias", dev(bias_name, torch.float32) if bias_name in t
            else torch.zeros((E,), dtype=torch.float32, device=device), False)
        for key, n in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                       ("w_down", "down_proj")):
            for e in range(E):
                put(key, dev(f"{pre}.experts.{e}.{n}.weight"), True, e)
        if cfg.n_shared_experts:
            for key, n in (("ws_gate", "gate_proj"), ("ws_up", "up_proj"),
                           ("ws_down", "down_proj")):
                put(key, dev(f"{pre}.shared_experts.{n}.weight"), True)

    def norm(name):
        """A norm vector; Gemma's scale by (1 + w), the fold made and kept
        in f32 as the JAX loader's ``norm_get`` does (``rms_norm`` applies
        f32 weights before its final cast)."""
        w = dev(name)
        return w.float() + 1.0 if cfg.norm_plus_one else w

    def norm_layer(i: int, put) -> None:
        pre = f"model.layers.{i}"
        put("attn_norm", norm(f"{pre}.input_layernorm.weight"), False)
        if cfg.sandwich_norms:
            # Gemma-2: post_attention_layernorm is the post-norm on the
            # attention output; the pre-MLP norm is pre_feedforward's
            put("post_attn_norm",
                norm(f"{pre}.post_attention_layernorm.weight"), False)
            put("mlp_norm", norm(f"{pre}.pre_feedforward_layernorm.weight"),
                False)
            put("post_mlp_norm",
                norm(f"{pre}.post_feedforward_layernorm.weight"), False)
        else:
            put("mlp_norm", norm(f"{pre}.post_attention_layernorm.weight"),
                False)

    def build_stack(idxs, moe: bool) -> dict:
        """One stacked layer group: each weight written into its [n, ...]
        (MoE experts: [n, E, ...]) slot as it comes off the file."""
        stack: dict[str, torch.Tensor] = {}
        n = len(idxs)

        for j, i in enumerate(idxs):
            def put(key, w, transpose, expert=None, j=j):
                w = w.T if transpose else w
                ok, g = (leaf_group(key, w.shape[0], *spec)
                         if spec and key not in stack else (False, None))
                if key not in stack:
                    lead = (n, cfg.num_experts) if expert is not None \
                        else (n,)
                    stack[key] = (empty_qtensor(lead, w.shape, spec[0], g,
                                                device) if ok else
                                  torch.empty((*lead, *w.shape),
                                              dtype=w.dtype, device=device))
                at = j if expert is None else (j, expert)
                if is_qtensor(stack[key]):
                    quantize_into(stack[key], at, w)
                else:
                    stack[key][at].copy_(w)

            norm_layer(i, put)
            attn_layer(i, put)
            (moe_mlp_layer if moe else dense_mlp_layer)(i, put)
        return stack

    params = {
        "embed": dev("model.embed_tokens.weight"),
        "layers": build_stack(range(k_dense, L), cfg.is_moe),
        "final_norm": norm("model.norm.weight"),
    }
    if k_dense:
        params["dense_layers"] = build_stack(range(k_dense), False)
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" in t:
            head = dev("lm_head.weight").T
            ok, g = (leaf_group("lm_head", head.shape[0], *spec) if spec
                     else (False, None))
            params["lm_head"] = (quantize(head, spec[0], g) if ok
                                 else head.contiguous())
        else:
            logger.warning("lm_head.weight missing; tying to embeddings")
            cfg.tie_word_embeddings = True
    return params


def load_model(path: str, device=None,
               dtype: Optional[torch.dtype] = None
               ) -> tuple[ModelConfig, dict]:
    """Config + params from a local HF model directory."""
    cfg = ModelConfig.from_pretrained(path)
    return cfg, load_hf_params(cfg, path, device, dtype)
