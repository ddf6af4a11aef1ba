"""The dense-family switches of the torch port against the JAX package.

- ``ModelConfig.from_hf_config`` field for field against the JAX one on
  Mistral, Qwen2 (window gated off and on), Qwen3, Qwen3-MoE, Gemma,
  Gemma-2 and gpt-oss config dicts, and the presets the port copied.
- Each architecture switch alone (q/k/v bias, Qwen3's q/k norm, a sliding
  window, per-layer windows, sinks, the o bias, the embed scale, GeLU-tanh,
  the attention and the final logit softcaps, sandwich norms,
  ``query_pre_attn_scalar``) and the Gemma-2 and gpt-oss-attention
  combinations: one packed ragged step and a dense prefill + S == 1 decode
  through the port's forward against the JAX forward, f32, atol/rtol 1e-4.
  The JAX init draws biases as zeros and norms as ones, so those leaves get
  seeded noise first (a missing bias or norm would otherwise pass).
- ``AsyncTorchEngine`` against ``AsyncJaxEngine`` on a Mistral-window, a
  Qwen2, a Qwen3 and a Gemma-2 config: greedy streams and KV-event block
  hashes equal.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_cache
from dynamo_tpu.engine.config import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from tests.test_torch_model import _pack

TOL = dict(atol=1e-4, rtol=1e-4)

# ------------------------------------------------------------- the config

HF_CONFIGS = {
    "mistral": {"architectures": ["MistralForCausalLM"],
                "hidden_size": 256, "num_attention_heads": 8,
                "num_key_value_heads": 2, "sliding_window": 4096},
    "qwen2": {"architectures": ["Qwen2ForCausalLM"], "hidden_size": 224,
              "num_attention_heads": 7, "num_key_value_heads": 1,
              "sliding_window": 4096, "use_sliding_window": False},
    "qwen2_window": {"architectures": ["Qwen2ForCausalLM"],
                     "sliding_window": 64, "use_sliding_window": True},
    "qwen3": {"architectures": ["Qwen3ForCausalLM"], "head_dim": 128,
              "num_attention_heads": 32, "num_key_value_heads": 8},
    "qwen3_moe": {"architectures": ["Qwen3MoeForCausalLM"], "head_dim": 128,
                  "num_experts": 128, "num_experts_per_tok": 8,
                  "moe_intermediate_size": 768, "norm_topk_prob": True},
    "gemma": {"architectures": ["GemmaForCausalLM"], "head_dim": 256,
              "hidden_activation": "gelu_pytorch_tanh",
              "tie_word_embeddings": True},
    "gemma2": {"architectures": ["Gemma2ForCausalLM"], "vocab_size": 256000,
               "hidden_size": 3584, "intermediate_size": 14336,
               "num_hidden_layers": 42, "num_attention_heads": 16,
               "num_key_value_heads": 8, "head_dim": 256,
               "query_pre_attn_scalar": 256, "sliding_window": 4096,
               "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0, "rms_norm_eps": 1e-6,
               "hidden_activation": "gelu_pytorch_tanh",
               "tie_word_embeddings": True},
    "gpt_oss": {"architectures": ["GptOssForCausalLM"],
                "num_hidden_layers": 4, "sliding_window": 128,
                "num_local_experts": 8, "num_experts_per_tok": 2},
}


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_hf_config_matches_jax(family):
    d = HF_CONFIGS[family]
    got = ModelConfig.from_hf_config(dict(d))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JaxModelConfig.from_hf_config(dict(d)))
    if family == "gemma2":
        assert got.layer_windows[:3] == (4096, 0, 4096)
        assert got.sandwich_norms and got.embed_scale and got.norm_plus_one
        TM.check_supported(got)
        TM.check_kernel_geometry(got)  # hd 256 and the softcap
    if family == "gpt_oss":  # its attention is served, its experts not
        with pytest.raises(NotImplementedError, match="A9"):
            TM.check_supported(got)


@pytest.mark.parametrize("name", ["mistral_7b", "qwen2_7b", "qwen3_8b",
                                  "qwen3_moe_30b_a3b", "mixtral_8x7b",
                                  "moe_tiny"])
def test_presets_match_jax(name):
    got = get_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_preset(name))
    TM.check_supported(got)
    if name != "moe_tiny":  # hd 16: a CPU test model
        TM.check_kernel_geometry(got)


# ------------------------------------------------------------- the switches

#: each switch alone on the tiny model (hd 16), and two combinations; the
#: caps are small enough to bend this model's scores and logits
SWITCHES = {
    "qkv_bias": {"qkv_bias": True},
    "qk_norm": {"qk_norm": True},
    "sliding_window": {"sliding_window": 5},
    "attention_sinks": {"attention_sinks": True},
    "attn_logit_softcap": {"attn_logit_softcap": 1.0},
    "sandwich_norms": {"sandwich_norms": True},
    "layer_windows": {"layer_windows": (4, 0)},
    "o_bias": {"o_bias": True},
    "embed_scale": {"embed_scale": True},
    "gelu_tanh": {"hidden_activation": "gelu_tanh"},
    "final_logit_softcap": {"final_logit_softcap": 0.5},
    "query_pre_attn_scalar": {"query_pre_attn_scalar": 24.0},
    "gemma2": dict(embed_scale=True, norm_plus_one=True,
                   hidden_activation="gelu_tanh", attn_logit_softcap=1.0,
                   final_logit_softcap=0.5, sandwich_norms=True,
                   query_pre_attn_scalar=24.0, layer_windows=(4, 0),
                   tie_word_embeddings=True),
    "gpt_oss_attention": dict(qkv_bias=True, o_bias=True,
                              attention_sinks=True, layer_windows=(4, 0)),
}
#: leaves the JAX init draws as zeros or ones: seeded noise on top
_NOISE = ("bq", "bk", "bv", "bo", "q_norm", "k_norm", "attn_norm",
          "mlp_norm", "post_attn_norm", "post_mlp_norm", "final_norm")


def _configs(switch: dict):
    tiny = dataclasses.asdict(ModelConfig.tiny())
    tiny.update(switch)
    return ModelConfig(**tiny), JaxModelConfig(**tiny)


def _shared_params(jcfg, seed: int):
    """The JAX init with every zero/one leaf perturbed by seeded noise:
    (JAX params, the same numbers as the port's params on the CPU)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, M.init_params(jcfg, jax.random.key(
        seed)))

    def noisy(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = noisy(v)
            elif k in _NOISE:
                out[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(
                    v.dtype)
            else:
                out[k] = v
        return out

    tree = noisy(tree)
    return (jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu"))


def _ragged_step(switch):
    cfg, jcfg = _configs(switch)
    args = EngineArgs(block_size=4, num_blocks=64, max_num_seqs=8,
                      max_num_batched_tokens=64, max_model_len=64)
    bs, nb = 4, 64
    jp, tp = _shared_params(jcfg, 0)
    rng = np.random.default_rng(0)
    # two decode rows deep enough for the windows, a fresh prefill chunk,
    # a continuing chunk
    rows = [(8, 1), (12, 1), (0, 7), (4, 5)]
    ops = _pack(rows, args, rng, nb)
    shape = (cfg.num_layers, nb * bs, cfg.num_kv_heads, cfg.head_dim)
    kc0 = rng.standard_normal(shape, np.float32)
    vc0 = rng.standard_normal(shape, np.float32)
    jl, jk, jv = M.make_ragged_step_fn(jcfg, bs)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(kc0),
        jnp.asarray(vc0))
    tk, tv = torch.from_numpy(kc0.copy()), torch.from_numpy(vc0.copy())
    tl, _, _ = TM.make_ragged_step_fn(cfg, bs)(
        tp, *(torch.from_numpy(a) for a in ops), tk, tv)
    n = len(rows)
    np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n], **TOL)
    for got, want in ((tk, jk), (tv, jv)):  # the null block excepted
        np.testing.assert_allclose(got.numpy()[:, bs:],
                                   np.asarray(want)[:, bs:], **TOL)
    return cfg, tl[:n]


def _dense_forward(switch):
    """A [2, 9] prefill (the second row shorter: padding to the null block),
    then one S == 1 decode step of both rows, through the port's dense
    forward and the JAX forward on the same caches."""
    cfg, jcfg = _configs(switch)
    jp, tp = _shared_params(jcfg, 1)
    bs = 4
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = [9, 5]
    toks = np.asarray([[5, 9, 17, 23, 42, 77, 101, 3, 54],
                       [7, 11, 13, 15, 17, 0, 0, 0, 0]], np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    slot = np.where(pos < np.asarray(lens)[:, None],
                    np.take_along_axis(bt, pos // bs, 1) * bs + pos % bs,
                    0).astype(np.int32)
    prefill = [toks, pos, slot, bt, np.asarray(lens, np.int32),
               np.asarray([8, 4], np.int32)]
    step = [np.asarray([[61], [62]], np.int32),
            np.asarray([[9], [5]], np.int32),
            np.asarray([[3 * bs + 1], [6 * bs + 1]], np.int32), bt,
            np.asarray([10, 6], np.int32), np.zeros((2,), np.int32)]
    kc, vc = jax_cache(jcfg, 10, bs, dtype=jnp.float32)
    tk, tv = torch.from_numpy(np.array(kc)), torch.from_numpy(np.array(vc))
    jfn = jax.jit(functools.partial(M.forward, cfg=jcfg, block_size=bs))
    tfn = TM.make_forward_fn(cfg, bs)
    for ops in (prefill, step):
        jl, kc, vc = jfn(jp, *(jnp.asarray(a) for a in ops), kc, vc)
        tl, _, _ = tfn(tp, *(torch.from_numpy(a) for a in ops), tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for got, want in ((tk, kc), (tv, vc)):
            np.testing.assert_allclose(got.numpy()[:, bs:],
                                       np.asarray(want)[:, bs:], **TOL)
    return tl


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_ragged_step_matches_jax(switch):
    cfg, logits = _ragged_step(SWITCHES[switch])
    if cfg.final_logit_softcap:
        assert float(logits.abs().max()) < cfg.final_logit_softcap


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_dense_forward_matches_jax(switch):
    _dense_forward(SWITCHES[switch])


def test_switches_change_the_step():
    """Each switch's parity is not a tautology: on the same weights, each
    switch moves the port's logits away from those with it off."""
    cfg0, jcfg = _configs(SWITCHES["gemma2"])
    _, tp = _shared_params(jcfg, 0)
    rng = np.random.default_rng(0)
    args = EngineArgs(block_size=4, num_blocks=64, max_num_seqs=8,
                      max_num_batched_tokens=64, max_model_len=64)
    ops = [torch.from_numpy(a) for a in _pack(
        [(8, 1), (12, 1), (0, 7), (4, 5)], args, rng, 64)]
    shape = (cfg0.num_layers, 64 * 4, cfg0.num_kv_heads, cfg0.head_dim)
    kc0 = torch.from_numpy(rng.standard_normal(shape, np.float32))

    def logits(cfg):
        return TM.make_ragged_step_fn(cfg, 4)(
            tp, *ops, kc0.clone(), kc0.clone())[0][:4]

    full = logits(cfg0)
    off = dict(embed_scale=False, hidden_activation="silu",
               attn_logit_softcap=0.0, final_logit_softcap=0.0,
               sandwich_norms=False, query_pre_attn_scalar=None,
               layer_windows=None)
    for name, value in off.items():
        got = logits(dataclasses.replace(cfg0, **{name: value}))
        assert float((got - full).abs().max()) > 1e-3, name


def test_engine_converts_sinks_to_f32_once():
    """The init draws sinks in the model dtype, as the JAX init does; the
    engine holds them in the kernels' f32 (the same values), so no step
    converts them."""
    cfg, _ = _configs(SWITCHES["gpt_oss_attention"])
    cfg.dtype = "bfloat16"
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, gen, "cpu")
    assert params["layers"]["sink"].dtype == torch.bfloat16
    eng = AsyncTorchEngine(cfg, EngineArgs(block_size=4, num_blocks=16,
                                           max_model_len=32),
                           params=params, device="cpu")
    assert eng.params["layers"]["sink"].dtype == torch.float32
    assert torch.equal(eng.params["layers"]["sink"],
                       params["layers"]["sink"].float())
    assert params["layers"]["sink"].dtype == torch.bfloat16  # not mutated
    assert eng.params["layers"]["wq"] is params["layers"]["wq"]


# ------------------------------------------------------------- the engines

SETTINGS = dict(block_size=4, num_blocks=128, max_num_seqs=8,
                max_num_batched_tokens=64, max_model_len=256,
                decode_batch_buckets=(1, 2, 4, 8))
#: the families' switches at test widths (Mistral's window short enough
#: to mask the prompts' keys; Qwen2's group of 3 with biases; Qwen3's q/k
#: norms at head_dim 32; Gemma-2 with everything)
ENGINE_CONFIGS = {
    "mistral_window": dict(sliding_window=12),
    "qwen2": dict(num_heads=6, num_kv_heads=2, hidden_size=96,
                  qkv_bias=True),
    "qwen3": dict(qk_norm=True, head_dim=32),
    "gemma2": dict(SWITCHES["gemma2"], layer_windows=(12, 0),
                   attn_logit_softcap=5.0, final_logit_softcap=3.0),
}


def _prompts():
    rng = np.random.default_rng(7)
    return [list(map(int, rng.integers(1, 256, n))) for n in (41, 9, 30, 17)]


async def _serve(eng, reqs):
    async def one(r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    try:
        return await asyncio.gather(*(one(r) for r in reqs))
    finally:
        await eng.close()


def _stored(events):
    return [[(b.block_hash, b.tokens_hash) for b in e.stored_blocks]
            for e in events if e.stored_blocks]


@pytest.mark.parametrize("family", list(ENGINE_CONFIGS))
def test_engine_streams_and_kv_events_match_jax(family):
    cfg, jcfg = _configs(ENGINE_CONFIGS[family])
    jp, tp = _shared_params(jcfg, 3)
    max_toks = (8, 5, 7, 6)

    async def run():
        jev, tev = [], []
        jout = await _serve(AsyncJaxEngine(
            jcfg, JaxEngineArgs(prefill_buckets=(8, 16, 32, 64), **SETTINGS),
            params=jp, event_cb=jev.append), [
            JaxRequest(model="m", token_ids=p,
                       stop_conditions=JaxStop(max_tokens=m,
                                               ignore_eos=True))
            for p, m in zip(_prompts(), max_toks)])
        tout = await _serve(AsyncTorchEngine(
            cfg, EngineArgs(**SETTINGS), params=tp, device="cpu",
            event_cb=tev.append), [
            PreprocessedRequest(model="m", token_ids=p,
                                stop_conditions=StopConditions(
                                    max_tokens=m, ignore_eos=True))
            for p, m in zip(_prompts(), max_toks)])
        return jout, tout, jev, tev

    jout, tout, jev, tev = asyncio.run(run())
    assert tout == jout
    assert [len(t) for t in tout] == list(max_toks)
    assert _stored(tev) and _stored(tev) == _stored(jev)
